"""The port's mesh tier held against the JAX package's, on CPU slots.

* ``fsdp_dim``, ``fsdp_spec`` and ``fit_clients_axis`` are the JAX
  package's pure functions: equal to them on every leaf shape of the tiny
  and the ``distilbert_base`` parameter trees (both layouts) and on a grid
  of client / axis / device counts; the cases of
  ``tests/test_mesh_fsdp.py::test_fsdp_spec_picks_largest_divisible_dim``
  and ``test_mesh_config_validates_fsdp`` hold as written.
* Meshes: ``make_mesh`` / ``make_host_mesh`` lay the JAX grids out (the
  same shapes and axis names, the same device-count errors), and slots
  that share a device never alias (every placement copies).
* The config's ``mesh`` section reads back from a JAX-written config
  field for field, the ``seq`` axis included, and refuses what the JAX
  one refuses with its messages.
* The mesh flags parse to the JAX parser's values, ``--seq-parallel``
  on ``federated`` and ``client`` included.
* ``python -m <port>.cli`` runs the CLI.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

JAX_PKG = "detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu"
PORT_PKG = JAX_PKG + "_torch"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

jmesh = importlib.import_module(JAX_PKG + ".parallel.mesh")
pmesh = importlib.import_module(PORT_PKG + ".parallel.mesh")
jcfg = importlib.import_module(JAX_PKG + ".config")
pcfg = importlib.import_module(PORT_PKG + ".config")
pconvert = importlib.import_module(PORT_PKG + ".models.convert")
pdistil = importlib.import_module(PORT_PKG + ".models.distilbert")

CPU2 = [torch.device("cpu")] * 2


def _shapes(preset: str) -> set[tuple[int, ...]]:
    """Every leaf shape of a preset's parameter tree, the JAX package's
    (flax init, abstract) and the port's (state dict) layouts."""
    import jax

    jdistil = importlib.import_module(JAX_PKG + ".models.distilbert")
    jc = getattr(jcfg.ModelConfig, preset)()
    tree = jax.eval_shape(lambda: jdistil.init_params(jdistil.DDoSClassifier(jc), jc, jax.random.key(0)))
    shapes = {tuple(int(d) for d in leaf.shape) for leaf in jax.tree.leaves(tree)}
    pc = getattr(pcfg.ModelConfig, preset)()
    shapes |= {tuple(t.shape) for t in pdistil.model_skeleton(pc).state_dict().values()}
    return shapes


@pytest.mark.parametrize("preset", ["tiny", "distilbert_base"])
def test_fsdp_dim_and_spec_equal_jax_on_every_leaf(preset):
    shapes = _shapes(preset)
    assert len(shapes) >= 6
    for shape in sorted(shapes):
        for n in (1, 2, 3, 4, 8):
            assert pmesh.fsdp_dim(shape, n) == jmesh.fsdp_dim(shape, n), (shape, n)
            assert pmesh.fsdp_spec(shape, n) == tuple(jmesh.fsdp_spec(shape, n)), (shape, n)


def test_fsdp_spec_picks_largest_divisible_dim():
    """tests/test_mesh_fsdp.py's case, on the port."""
    assert pmesh.fsdp_dim((6, 4), 2) == 0
    assert pmesh.fsdp_dim((4, 6), 2) == 1
    assert pmesh.fsdp_dim((3, 5), 2) is None
    assert pmesh.fsdp_dim((), 2) is None
    assert pmesh.fsdp_dim((8, 8), 2) == 0
    assert pmesh.fsdp_dim((8,), 1) is None
    assert pmesh.fsdp_spec((6, 4), 2) == ("data", None)
    assert pmesh.fsdp_spec((4, 6), 2) == (None, "data")
    assert pmesh.fsdp_spec((3, 5), 2) == ()
    assert pmesh.fsdp_spec((1024, 768), 4) == pmesh.fsdp_spec((1024, 768), 4)


def test_fit_clients_axis_equals_jax():
    for clients in range(1, 17):
        for data in (1, 2, 3, 4):
            for n_dev in (1, 2, 4, 8):
                try:
                    want = jmesh.fit_clients_axis(clients, data, n_dev)
                except ValueError as e:
                    with pytest.raises(ValueError, match="exceeds"):
                        pmesh.fit_clients_axis(clients, data, n_dev)
                    assert "exceeds" in str(e)
                    continue
                assert pmesh.fit_clients_axis(clients, data, n_dev) == want, (clients, data, n_dev)


def test_meshes_lay_out_the_jax_grids(eight_devices):
    for dims in ((4, 2), (2, 1), (1, 8)):
        j, p = jmesh.make_mesh(*dims, devices=eight_devices), pmesh.make_mesh(*dims, device="cpu")
        assert p.devices.shape == j.devices.shape and p.axis_names == tuple(j.axis_names)
        assert p.shape == dict(j.shape)
    j3, p3 = jmesh.make_mesh(2, 2, seq=2, devices=eight_devices), pmesh.make_mesh(2, 2, seq=2, device="cpu")
    assert p3.devices.shape == j3.devices.shape and p3.axis_names == ("clients", "data", "seq")
    for n in (1, 2, 8):
        j, p = jmesh.make_host_mesh(n, devices=eight_devices), pmesh.make_host_mesh(n, device="cpu")
        assert p.devices.shape == j.devices.shape and p.axis_names == tuple(j.axis_names) == ("data",)
    with pytest.raises(ValueError, match="devices"):
        pmesh.make_host_mesh(9, device="cpu")
    with pytest.raises(ValueError, match="devices"):
        jmesh.make_host_mesh(9, devices=eight_devices)
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        pmesh.make_mesh(4, 4, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        pmesh.make_host_mesh(0, device="cpu")
    # An explicit slot list (two slots on one device, as one card holds them).
    m = pmesh.make_host_mesh(2, devices=CPU2)
    assert m.slots() == CPU2 and m == pmesh.make_host_mesh(2, devices=CPU2) and hash(m) == hash(pmesh.make_host_mesh(2, devices=CPU2))
    sh = pmesh.FedShardings(pmesh.make_mesh(2, 2, device="cpu"))
    assert [list(r) for r in sh.client_rows(4)] == [[0, 1], [2, 3]]
    assert sh.batch_rows(8) == [slice(0, 4), slice(4, 8)]
    assert len(sh.row_slots(1)) == 2 and len(sh.replicated()) == 4
    with pytest.raises(ValueError, match="does not split"):
        sh.batch_rows(7)


def test_cuda_slots_raise_without_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.make_host_mesh(1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.local_devices("cuda")


def test_slots_sharing_a_device_never_alias():
    """Every placement onto a slot copies: a shard, a gathered leaf and a
    slot copy own their storage even where ``to()`` would alias."""
    t = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    leaf = pmesh.ShardedLeaf.scatter(t, CPU2)
    assert leaf.dim == 0 and [tuple(s.shape) for s in leaf.shards] == [(3, 4), (3, 4)]
    ptrs = {s.untyped_storage().data_ptr() for s in leaf.shards} | {t.untyped_storage().data_ptr()}
    assert len(ptrs) == 3
    full = leaf.gather("cpu")
    assert torch.equal(full, t) and full.untyped_storage().data_ptr() not in ptrs
    leaf.shards[0].add_(1.0)  # writing one slot leaves the others and the source
    assert torch.equal(leaf.shards[1], t[3:]) and torch.equal(t, torch.arange(24, dtype=torch.float32).reshape(6, 4))
    c = pmesh.slot_copy(t, torch.device("cpu"))
    assert torch.equal(c, t) and c.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()
    # Undividable and scalar leaves stay whole on the first slot.
    odd = pmesh.ShardedLeaf.scatter(torch.ones(3), CPU2)
    assert odd.dim is None and len(odd.shards) == 1
    back = leaf.like(full * 2)
    assert torch.equal(back.gather("cpu"), full * 2) and back.dim == leaf.dim
    # A transposed leaf (a kernel from the JAX layout) gathers with its
    # source's strides as well as its bytes.
    kt = torch.arange(24, dtype=torch.float32).reshape(4, 6).T
    tl = pmesh.ShardedLeaf.scatter(kt, CPU2)
    got = tl.gather("cpu")
    assert torch.equal(got, kt) and got.stride() == kt.stride() and tl.dim == 0
    assert torch.equal(tl.like(kt * 3).gather("cpu"), kt * 3)
    with pytest.raises(ValueError, match="does not fit"):
        leaf.like(torch.ones(4, 6))


def test_device_tree_bytes_counts_one_slot():
    t = torch.zeros(8, 4)
    tree = {"a": pmesh.ShardedLeaf.scatter(t, CPU2), "b": torch.zeros(3), "c": pmesh.ShardedLeaf.scatter(torch.zeros(3), CPU2)}
    assert pmesh.device_tree_bytes(tree) == 4 * 4 * 4 + 3 * 4 + 3 * 4
    assert pmesh.device_tree_bytes((tree, [torch.zeros(2)])) == 4 * 4 * 4 + 3 * 4 + 3 * 4 + 8
    assert pmesh.device_tree_bytes(torch.nn.Linear(2, 3)) == (6 + 3) * 4


def test_mesh_config_reads_a_jax_config_field_for_field():
    want = jcfg.ExperimentConfig(
        fed=jcfg.FedConfig(num_clients=4), mesh=jcfg.MeshConfig(clients=4, data=2, fsdp=True)
    )
    d = json.loads(json.dumps(want.to_dict()))
    got = pcfg.ExperimentConfig.from_dict(d)
    assert dataclasses.asdict(got.mesh) == dataclasses.asdict(want.mesh)
    assert got.mesh.axis_names == ("clients", "data")
    assert pcfg.ExperimentConfig.from_dict(json.loads(json.dumps(got.to_dict()))) == got
    assert dataclasses.asdict(pcfg.MeshConfig()) == dataclasses.asdict(jcfg.MeshConfig())
    # The port's mesh section reads back into the JAX package too.
    assert dataclasses.asdict(jcfg.ExperimentConfig.from_dict(got.to_dict()).mesh) == dataclasses.asdict(want.mesh)
    assert not hasattr(pcfg, "_JAX_ONLY_SECTIONS")


def test_mesh_config_validates_as_jax():
    """tests/test_mesh_fsdp.py::test_mesh_config_validates_fsdp on both
    packages, word for word, and the sequence-parallel axis validates and
    reads back to the JAX package's values."""
    msgs = []
    for mod in (jcfg, pcfg):
        got = []
        for kw in (dict(clients=1, data=1, fsdp=True), dict(clients=1, data=2, seq=2, fsdp=True),
                   dict(clients=0), dict(seq=0)):
            with pytest.raises(ValueError) as e:
                mod.MeshConfig(**kw)
            got.append(str(e.value))
        msgs.append(got)
        assert "data >= 2" in got[0] and "seq" in got[1] and ">= 1" in got[2]
    assert msgs[0] == msgs[1]
    assert dataclasses.asdict(pcfg.MeshConfig(seq=2)) == dataclasses.asdict(jcfg.MeshConfig(seq=2))
    got = pcfg.ExperimentConfig.from_dict({"mesh": {"seq": 2, "data": 2}}).mesh
    assert dataclasses.asdict(got) == dataclasses.asdict(jcfg.ExperimentConfig.from_dict({"mesh": {"seq": 2, "data": 2}}).mesh)


@pytest.mark.parametrize(
    "argv",
    [
        ["federated", "--data-parallel", "2", "--coordinator", "127.0.0.1:5555", "--num-processes", "2",
         "--process-id", "1"],
        ["federated"],
        ["client", "--client-id", "0", "--data-parallel", "4", "--fsdp"],
        ["client", "--client-id", "0"],
        ["infer-serve", "--registry-dir", "r", "--data-parallel", "2", "--fsdp"],
        ["infer-serve", "--registry-dir", "r"],
    ],
)
def test_mesh_flags_parse_as_jax(argv):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
        build_parser as jax_parser,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        build_parser,
    )

    args, jargs = build_parser().parse_args(argv), jax_parser().parse_args(argv)
    for name in ("data_parallel", "seq_parallel", "fsdp", "coordinator", "num_processes", "process_id"):
        if hasattr(jargs, name):
            assert getattr(args, name) == getattr(jargs, name), name
    seq = [*argv, "--seq-parallel", "2"]
    if argv[0] == "infer-serve":  # no sequence-parallel scorer in either package
        for parser in (build_parser(), jax_parser()):
            with pytest.raises(SystemExit):
                parser.parse_args(seq)
    else:
        assert build_parser().parse_args(seq).seq_parallel == jax_parser().parse_args(seq).seq_parallel == 2


def test_client_config_resolves_the_mesh_as_jax(tmp_path):
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli import (
        build_parser as jax_parser,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu.cli.common import (
        resolve_config as jax_resolve,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli import (
        build_parser,
    )
    from detecting_cyber_attacks_with_distilled_large_language_models_in_distributed_networks_tpu_torch.cli.common import (
        resolve_config,
    )

    for extra in ([], ["--data-parallel", "2"], ["--data-parallel", "2", "--fsdp"], ["--num-clients", "3"]):
        argv = ["client", "--client-id", "0", *extra]
        got = resolve_config(build_parser().parse_args(argv), vocab_size=100).mesh
        want = jax_resolve(jax_parser().parse_args(argv), vocab_size=100).mesh
        assert dataclasses.asdict(got) == dataclasses.asdict(want), extra
    for bad in (["--data-parallel", "1", "--fsdp"], ["--data-parallel", "0"]):
        argv = ["client", "--client-id", "0", *bad]
        with pytest.raises(SystemExit) as e:
            resolve_config(build_parser().parse_args(argv), vocab_size=100)
        with pytest.raises(SystemExit) as je:
            jax_resolve(jax_parser().parse_args(argv), vocab_size=100)
        assert str(e.value) == str(je.value)


def test_python_dash_m_cli_runs():
    res = subprocess.run(
        [sys.executable, "-m", PORT_PKG + ".cli", "--help"], capture_output=True, text=True, timeout=120, cwd=REPO
    )
    assert res.returncode == 0, res.stderr
    assert "federated" in res.stdout and "infer-serve" in res.stdout
