"""The port's model registry held against the JAX package's, on the CPU.

* the same weights get the same artifact id and equal ``params.npz``
  arrays whether the port (from its state dict) or the JAX package (from
  its params tree) adds them;
* each package reads the other's artifacts: manifest, params and the
  ``ModelConfig`` the manifest records;
* promote, reject, rollback and gc interleaved between the packages on
  one root leave the pointer and the events the JAX package alone leaves;
* ``add(extra=)`` writes the JAX package's manifest byte for byte;
* tests/test_registry.py's cases that need no controller, on the port.
"""

import dataclasses
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.config import (
    ModelConfig as JaxModelConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.models.distilbert import (
    DDoSClassifier as JaxClassifier,
    init_params as jax_init_params,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.registry import (
    ModelRegistry as JaxRegistry,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.registry.store import (
    artifact_id as jax_artifact_id,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
    main,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.comm.wire import (
    flatten_params,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.config import (
    ModelConfig,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.models import (
    init_params,
    params_from_jax,
    params_to_jax,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.registry import (
    ModelRegistry,
    RegistryError,
)
from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.registry.store import (
    artifact_id,
)

torch.set_num_threads(1)


def _params(seed, shape=(8, 4)):
    """Flat '/'-keyed params, the form both packages' ``add`` take."""
    rng = np.random.default_rng(seed)
    return {
        "encoder/w": rng.normal(size=shape).astype(np.float32),
        "head/b": rng.normal(size=shape[1]).astype(np.float32),
    }


def _tiny(seed=0):
    cfg = ModelConfig.tiny()
    return cfg, init_params(cfg, torch.Generator().manual_seed(seed))


@pytest.fixture()
def registry(tmp_path):
    return ModelRegistry(str(tmp_path / "registry"))


def _events(root):
    with open(os.path.join(root, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


# ------------------------------------------------------ against the JAX package
def test_same_weights_same_id_and_arrays_in_both_packages(tmp_path):
    jcfg = JaxModelConfig.tiny()
    tree = jax.tree.map(np.asarray, jax_init_params(JaxClassifier(jcfg), jcfg, jax.random.key(3)))
    state_dict = params_from_jax(tree)
    assert artifact_id(state_dict) == jax_artifact_id(tree) == artifact_id(flatten_params(tree))
    port = ModelRegistry(str(tmp_path / "port")).add(state_dict, round_index=1)
    jax_id = JaxRegistry(str(tmp_path / "jax")).add(tree, round_index=1)
    assert port == jax_id
    with np.load(tmp_path / "port" / "artifacts" / port / "params.npz") as a, \
            np.load(tmp_path / "jax" / "artifacts" / jax_id / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])


def test_add_with_extra_writes_the_jax_manifest_byte_for_byte(tmp_path, monkeypatch):
    """The ``federated`` verb's artifact: metrics, model config and
    ``extra``; without ``extra`` the key is absent in both."""
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.registry import (
        store as jax_store,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.registry import (
        store as port_store,
    )

    monkeypatch.setattr(jax_store.time, "time", lambda: 1234.5)
    monkeypatch.setattr(port_store.time, "time", lambda: 1234.5)
    jcfg = JaxModelConfig.tiny()
    tree = jax.tree.map(np.asarray, jax_init_params(JaxClassifier(jcfg), jcfg, jax.random.key(5)))
    metrics = {"Accuracy": 91.25, "Loss": 0.25, "Precision": 0.5, "Recall": 1.0, "F1-Score": 0.6666666666666666}
    for extra in ({"tier": "mesh", "clients": 4}, None):
        kw = dict(round_index=3, metrics=metrics, extra=extra)
        port = ModelRegistry(str(tmp_path / f"port{extra is None}")).add(
            params_from_jax(tree), model_config=ModelConfig.tiny(), **kw
        )
        jax_id = JaxRegistry(str(tmp_path / f"jax{extra is None}")).add(tree, model_config=jcfg, **kw)
        assert port == jax_id
        with open(tmp_path / f"port{extra is None}" / "artifacts" / port / "manifest.json", "rb") as f, \
                open(tmp_path / f"jax{extra is None}" / "artifacts" / jax_id / "manifest.json", "rb") as g:
            got, want = f.read(), g.read()
        assert got == want
        assert (b'"extra"' in got) is (extra is not None)


def test_each_package_reads_the_others_artifacts(tmp_path):
    cfg, sd = _tiny(1)
    root = str(tmp_path / "shared")
    port, jreg = ModelRegistry(root), JaxRegistry(root)
    a = port.add(sd, round_index=4, metrics={"Accuracy": 91.5, "probs": np.zeros(3)}, model_config=cfg)
    m = jreg.manifest(a)
    assert m["round"] == 4 and m["metrics"] == {"Accuracy": 91.5}
    assert JaxModelConfig(**m["model_config"]) == JaxModelConfig(**dataclasses.asdict(cfg))
    back = jreg.load_params(a)  # the JAX reader's nested tree
    want = params_to_jax(sd)
    for k, v in flatten_params(want).items():
        np.testing.assert_array_equal(flatten_params(back)[k], v)
    # And the reverse: an artifact the JAX package wrote.
    jcfg = JaxModelConfig.tiny(gelu="tanh")
    tree = jax.tree.map(np.asarray, jax_init_params(JaxClassifier(jcfg), jcfg, jax.random.key(5)))
    b = jreg.add(tree, round_index=7, model_config=jcfg)
    m = port.manifest(b)
    assert ModelConfig(**m["model_config"]) == ModelConfig.tiny(gelu="tanh")
    got = params_from_jax(port.load_params(b))
    for k, t in params_from_jax(tree).items():
        assert torch.equal(got[k], t)
    assert {x["id"] for x in port.list()} == {x["id"] for x in jreg.list()} == {a, b}


def _strip(obj):
    """Pointer / event without its wall-clock fields."""
    return {k: v for k, v in obj.items() if not (k == "ts" or k.endswith("_unix"))}


def test_interleaved_transitions_leave_the_jax_packages_state(tmp_path):
    ids_params = [_params(i) for i in range(5)]

    def run(reg_for_step):
        root = str(tmp_path / str(len(os.listdir(tmp_path))))
        regs = {"jax": JaxRegistry(root), "port": ModelRegistry(root)}
        steps = [
            ("add", 0), ("add", 1), ("add", 2), ("add", 3), ("add", 4),
            ("promote", 0), ("promote", 0), ("serve", 1), ("reject", 2), ("serve", 3),
            ("rollback", None), ("gc", 2), ("promote-shadow", 4),
        ]
        ids = []
        for i, (op, arg) in enumerate(steps):
            reg = regs[reg_for_step(i)]
            if op == "add":
                ids.append(reg.add(ids_params[arg], round_index=arg))
            elif op == "promote":
                reg.promote(ids[arg])
            elif op == "serve":
                reg.promote(ids[arg], to="serving")
            elif op == "reject":
                reg.reject(ids[arg], reason="gate regression")
            elif op == "rollback":
                reg.rollback()
            elif op == "gc":
                reg.gc(max_artifacts=arg)
            else:
                reg.promote(ids[arg], to="shadow")
        manifests = {m["id"]: _strip(m) for m in regs["jax"].list()}
        return (
            _strip(regs["jax"].serving_info()),
            _strip(regs["jax"].shadow_info()),
            [_strip(e) for e in _events(root)],
            manifests,
        )

    want = run(lambda i: "jax")
    assert run(lambda i: "port" if i % 2 else "jax") == want
    assert run(lambda i: "jax" if i % 2 else "port") == want
    assert run(lambda i: "port") == want


def test_registry_cli_list_promote_rollback_gc(tmp_path, capsys):
    root = str(tmp_path / "r")
    reg = JaxRegistry(root)  # the JAX package writes; the port's verbs act
    a = reg.add(_params(0), round_index=0, metrics={"Accuracy": 0.8})
    b = reg.add(_params(1), round_index=1)
    assert main(["registry", "list", "--registry-dir", root]) == 0
    assert a in capsys.readouterr().out
    assert main(["registry", "promote", "--registry-dir", root, "--artifact", a, "--to", "serving"]) == 0
    assert main(["registry", "promote", "--registry-dir", root, "--artifact", b, "--to", "serving"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == f"{b} -> serving"
    assert main(["registry", "rollback", "--registry-dir", root]) == 0
    assert reg.serving_info()["artifact"] == a
    assert main(["registry", "gc", "--registry-dir", root, "--max-artifacts", "1"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "1 artifact(s) pruned, 1 kept"
    with pytest.raises(SystemExit, match="--artifact"):
        main(["registry", "promote", "--registry-dir", root])
    with pytest.raises(SystemExit, match="--max-artifacts"):
        main(["registry", "gc", "--registry-dir", root])
    with pytest.raises(SystemExit, match="no predecessor"):
        main(["registry", "rollback", "--registry-dir", root])


# ------------------------------------------------- tests/test_registry.py's cases
def test_content_addressing_dedups_and_roundtrips(registry):
    p = _params(0)
    a = registry.add(p, round_index=1, metrics={"Accuracy": 0.9})
    assert registry.add(p, round_index=99) == a
    assert a == artifact_id(p) == jax_artifact_id(p)
    assert artifact_id(_params(1)) != a
    back = registry.load_params(a)
    np.testing.assert_array_equal(back["encoder/w"], p["encoder/w"])
    np.testing.assert_array_equal(back["head/b"], p["head/b"])
    m = registry.manifest(a)
    assert m["state"] == "candidate" and m["round"] == 1
    assert m["metrics"]["Accuracy"] == pytest.approx(0.9)


def test_state_dict_and_its_flat_form_share_an_address_and_trees_are_refused(registry):
    _, sd = _tiny(2)
    flat = flatten_params(params_to_jax(sd))
    assert artifact_id(sd) == artifact_id(flat) == jax_artifact_id(params_to_jax(sd))
    a = registry.add(sd, round_index=0)
    assert registry.add(flat, round_index=1) == a
    back = registry.load_params(a)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
    with pytest.raises(TypeError, match="nested tree"):
        registry.add(params_to_jax(sd), round_index=2)


def test_registry_creates_no_directory_until_the_first_add(tmp_path):
    root = tmp_path / "typo"
    reg = ModelRegistry(str(root))
    assert reg.list() == [] and reg.serving_info() is None
    assert not root.exists()
    a = reg.add(_params(0), round_index=0)
    assert (root / "artifacts" / a / "params.npz").is_file()


def test_promotion_ladder_and_pointer(registry):
    a1 = registry.add(_params(0), round_index=0, metrics={"Accuracy": 0.8})
    assert registry.serving_info() is None
    registry.promote(a1)  # candidate -> shadow
    assert registry.manifest(a1)["state"] == "shadow"
    assert registry.shadow_info()["artifact"] == a1
    assert registry.serving_info() is None
    registry.promote(a1)  # shadow -> serving
    info = registry.serving_info()
    assert info["artifact"] == a1 and info["history"] == []
    assert registry.shadow_info() is None
    with pytest.raises(RegistryError):
        registry.promote(a1)
    with pytest.raises(RegistryError, match="CANDIDATE"):
        registry.promote(a1, to="shadow")
    a2 = registry.add(_params(1), round_index=1, metrics={"Accuracy": 0.9})
    registry.promote(a2, to="serving")
    assert registry.serving_info()["artifact"] == a2
    assert registry.serving_info()["history"] == [a1]
    assert registry.manifest(a1)["state"] == "retired"
    assert registry.serving_manifest()["id"] == a2


def test_rejected_candidate_never_reaches_the_pointer(registry):
    a1 = registry.add(_params(0), round_index=0)
    registry.promote(a1, to="serving")
    a2 = registry.add(_params(1), round_index=1)
    registry.reject(a2, reason="gate regression")
    assert registry.manifest(a2)["state"] == "rejected"
    assert registry.serving_info()["artifact"] == a1
    with pytest.raises(RegistryError):
        registry.promote(a2)


def test_rollback_swaps_back_and_chains(registry):
    ids = [registry.add(_params(i), round_index=i) for i in range(3)]
    for a in ids:
        registry.promote(a, to="serving")
    m = registry.rollback()
    assert m["id"] == ids[1] and registry.serving_info()["artifact"] == ids[1]
    assert registry.manifest(ids[2])["state"] == "retired"
    assert registry.rollback()["id"] == ids[0]
    with pytest.raises(RegistryError):
        registry.rollback()


def test_rollback_without_serving_fails(registry):
    with pytest.raises(RegistryError):
        registry.rollback()


def test_pointer_swap_is_atomic_under_a_concurrent_reader(registry):
    ids = [registry.add(_params(i), round_index=i) for i in range(6)]
    registry.promote(ids[0], to="serving")
    stop = threading.Event()
    bad: list = []
    reads = [0]

    def reader():
        while not stop.is_set():
            try:
                info = registry.serving_info()
                if info is None or info["artifact"] not in ids:
                    bad.append(info)
                    return
                registry.manifest(info["artifact"])
                reads[0] += 1
            except Exception as e:  # a torn read
                bad.append(e)
                return

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    for a in ids[1:]:
        registry.promote(a, to="serving")
    for _ in range(3):
        registry.rollback()
    stop.set()
    t.join(timeout=10)
    assert not t.is_alive() and not bad, bad
    assert reads[0] > 0


def test_events_jsonl_records_the_lifecycle(registry):
    a1 = registry.add(_params(0), round_index=0)
    registry.promote(a1, to="serving")
    a2 = registry.add(_params(1), round_index=1)
    registry.reject(a2, reason="worse")
    events = _events(registry.root)
    assert [e["event"] for e in events] == ["added", "serving", "added", "rejected"]
    assert events[3]["reason"] == "worse"


def test_gc_prunes_retired_rejected_never_the_rollback_chain(registry):
    ids = [registry.add(_params(i), round_index=i) for i in range(6)]
    for a in ids[:4]:
        registry.promote(a, to="serving")
    registry.reject(ids[4], reason="worse")
    registry.rollback()  # serving -> ids[2]; ids[3] retired off the chain
    assert set(registry.serving_info()["history"]) == {ids[0], ids[1]}
    removed = registry.gc(max_artifacts=4)
    assert removed == [ids[3], ids[4]]
    kept = {m["id"] for m in registry.list()}
    assert kept == {ids[0], ids[1], ids[2], ids[5]}
    assert registry.gc(max_artifacts=1) == []
    assert {m["id"] for m in registry.list()} == kept
    registry.rollback()
    registry.rollback()
    assert registry.serving_info()["artifact"] == ids[0]
    gc_events = [e for e in _events(registry.root) if e["event"] == "gc"]
    assert len(gc_events) == 1 and gc_events[0]["removed"] == removed
    with pytest.raises(RegistryError, match="max_artifacts"):
        registry.gc(max_artifacts=0)


def test_gc_never_reports_a_failed_deletion_as_pruned(registry, monkeypatch):
    import shutil as _shutil

    registry.add(_params(0), round_index=0)
    victim = registry.add(_params(9), round_index=9)
    registry.reject(victim, reason="worse")
    real_rmtree = _shutil.rmtree

    def _stuck(path, **kw):
        if os.path.basename(path) == victim:
            return
        return real_rmtree(path, **kw)

    monkeypatch.setattr(_shutil, "rmtree", _stuck)
    assert victim not in registry.gc(max_artifacts=1)
    assert victim in {m["id"] for m in registry.list()}
    assert all(victim not in e["removed"] for e in _events(registry.root) if e["event"] == "gc")
    monkeypatch.setattr(_shutil, "rmtree", real_rmtree)
    assert victim in registry.gc(max_artifacts=1)
