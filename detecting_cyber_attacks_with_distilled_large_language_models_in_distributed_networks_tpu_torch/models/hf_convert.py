"""HF DistilBERT checkpoints <-> the port's state dict (the port of the
JAX package's ``models/hf_convert.py``).

The reference starts from HF ``distilbert-base-uncased`` (reference
client1.py:56) and saves its ``DDoSClassifier`` state dicts (``distilbert.``
encoder + ``classifier`` head, client1.py:53-58,388). The port's modules
hold torch's ``[out, in]`` Linear weights, as HF does, so a key maps by
name alone (no transpose either way):

* ``embeddings.word_embeddings`` / ``position_embeddings`` / ``LayerNorm``
  -> ``encoder.embeddings.{word_embeddings, position_embeddings, ln}``;
* ``transformer.layer.{i}.attention.{q,k,v,out}_lin`` ->
  ``encoder.layer_{i}.attn.{q,k,v,o}``; ``sa_layer_norm`` -> ``sa_ln``;
  ``ffn.lin1``/``ffn.lin2`` -> ``lin1``/``lin2``; ``output_layer_norm`` ->
  ``out_ln``;
* ``classifier`` -> ``classifier``.

Weights load from ``model.safetensors`` (through :mod:`.safetensors`,
without the ``safetensors`` package) or ``pytorch_model.bin`` /
a ``.pth`` (``torch.load(weights_only=True)``). A bare encoder gets a
fresh head drawn from ``np.random.default_rng`` exactly as the JAX
package draws it, so both packages start ``--hf-dir`` runs from the same
weights.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import numpy as np
import torch

from ..config import ModelConfig
from . import safetensors as st

ST_FILE = "model.safetensors"
BIN_FILE = "pytorch_model.bin"


def _np(t: Any) -> np.ndarray:
    """A torch tensor or array-like -> float32 numpy."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, dtype=np.float32)


def _strip_prefix(sd: Mapping[str, Any]) -> tuple[dict[str, Any], bool]:
    """Keys in the bare encoder's space; returns (dict, has a head)."""
    out: dict[str, Any] = {}
    has_head = False
    for k, v in sd.items():
        if k.startswith("distilbert."):
            out[k[len("distilbert."):]] = v
        else:
            out[k] = v
            has_head = has_head or k.startswith("classifier.")
    return out, has_head


def _layer_names(i: int) -> list[tuple[str, str]]:
    """(port module, HF module) pairs of encoder layer ``i``."""
    p = f"transformer.layer.{i}"
    return [
        (f"encoder.layer_{i}.attn.q", f"{p}.attention.q_lin"),
        (f"encoder.layer_{i}.attn.k", f"{p}.attention.k_lin"),
        (f"encoder.layer_{i}.attn.v", f"{p}.attention.v_lin"),
        (f"encoder.layer_{i}.attn.o", f"{p}.attention.out_lin"),
        (f"encoder.layer_{i}.sa_ln", f"{p}.sa_layer_norm"),
        (f"encoder.layer_{i}.lin1", f"{p}.ffn.lin1"),
        (f"encoder.layer_{i}.lin2", f"{p}.ffn.lin2"),
        (f"encoder.layer_{i}.out_ln", f"{p}.output_layer_norm"),
    ]


def _module_names(cfg: ModelConfig) -> list[tuple[str, str]]:
    """Every (port module, HF module) pair but the head's, in the HF
    export's order."""
    names = [
        ("encoder.embeddings.word_embeddings", "embeddings.word_embeddings"),
        ("encoder.embeddings.position_embeddings", "embeddings.position_embeddings"),
        ("encoder.embeddings.ln", "embeddings.LayerNorm"),
    ]
    for i in range(cfg.n_layers):
        names += _layer_names(i)
    return names


def hf_to_port(
    state_dict: Mapping[str, Any], cfg: ModelConfig, head_rng: np.random.Generator | None = None
) -> dict[str, torch.Tensor]:
    """An HF/torch state dict (bare ``DistilBertModel`` or the reference's
    ``DDoSClassifier``) -> the port's fp32 state dict (CPU copies).

    Without ``classifier.*`` keys the head is fresh: a normal(initializer
    range) ``[dim, n_classes]`` kernel drawn from ``head_rng`` (default
    ``default_rng(0)``) and zero bias, the JAX package's draw, stored
    transposed as torch's ``[n_classes, dim]`` weight (reference
    client1.py:58). HF ``DistilBertForSequenceClassification`` checkpoints
    (with a ``pre_classifier`` layer this head lacks) are refused:
    converting only ``classifier.*`` would silently drop trained weights."""
    sd, has_head = _strip_prefix(state_dict)
    if any(k.startswith("pre_classifier.") for k in sd):
        raise ValueError(
            "this is an HF sequence-classification checkpoint (it has a "
            "pre_classifier layer this architecture lacks) — converting it "
            "would silently drop trained weights. Start from its bare "
            "encoder instead and fine-tune here (local/federated)."
        )
    out: dict[str, torch.Tensor] = {}
    for port, hf in _module_names(cfg):
        out[f"{port}.weight"] = torch.tensor(_np(sd[f"{hf}.weight"]))
        if not port.endswith("_embeddings"):
            out[f"{port}.bias"] = torch.tensor(_np(sd[f"{hf}.bias"]))
    if has_head:
        out["classifier.weight"] = torch.tensor(_np(sd["classifier.weight"]))
        out["classifier.bias"] = torch.tensor(_np(sd["classifier.bias"]))
    else:
        rng = head_rng or np.random.default_rng(0)
        kernel = rng.normal(0, cfg.initializer_range, (cfg.dim, cfg.n_classes)).astype(np.float32)
        out["classifier.weight"] = torch.tensor(np.ascontiguousarray(kernel.T))
        out["classifier.bias"] = torch.zeros(cfg.n_classes)
    return out


def port_to_hf(params: Mapping[str, torch.Tensor], cfg: ModelConfig) -> dict[str, np.ndarray]:
    """The port's state dict -> the reference's full-classifier key space
    (``distilbert.*`` + ``classifier.*``) as C-ordered fp32 numpy copies,
    e.g. to export a checkpoint a reference client loads."""
    out: dict[str, np.ndarray] = {}
    for port, hf in [*_module_names(cfg), ("classifier", "classifier")]:
        prefix = hf if port == "classifier" else f"distilbert.{hf}"
        out[f"{prefix}.weight"] = np.ascontiguousarray(_np(params[f"{port}.weight"]))
        if not port.endswith("_embeddings"):
            out[f"{prefix}.bias"] = np.ascontiguousarray(_np(params[f"{port}.bias"]))
    return out


def _weights_path(path: str) -> str:
    for name in (ST_FILE, BIN_FILE):
        if os.path.exists(os.path.join(path, name)):
            return os.path.join(path, name)
    raise FileNotFoundError(f"no {ST_FILE} or {BIN_FILE} under {path}")


def _load_weights(path: str) -> Mapping[str, Any]:
    weights = _weights_path(path)
    if weights.endswith(ST_FILE):
        return st.load_file(weights)
    return torch.load(weights, map_location="cpu", weights_only=True)


def hf_dir_has_head(path: str) -> bool:
    """Whether the checkpoint directory holds trained ``classifier.*``
    weights (a bare encoder's head would be random; fine to train from,
    meaningless to score with). Reads a safetensors header alone."""
    weights = _weights_path(path)
    if weights.endswith(ST_FILE):
        keys = st.tensor_names(weights)
    else:
        keys = list(torch.load(weights, map_location="cpu", weights_only=True))
    return any(k.startswith("classifier.") for k in keys)


def config_from_hf_dir(path: str, **overrides: Any) -> ModelConfig:
    """``config.json`` of an HF DistilBERT checkpoint directory ->
    ModelConfig: the architecture from the checkpoint (``activation``
    "gelu" is the erf form, "gelu_new"/"gelu_pytorch_tanh" the tanh one),
    the training knobs from ``overrides`` or the defaults; ``max_len``
    defaults to min(128, the position table)."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    activation = hf.get("activation", "gelu")
    kw: dict[str, Any] = dict(
        vocab_size=hf["vocab_size"],
        dim=hf["dim"],
        n_layers=hf["n_layers"],
        n_heads=hf["n_heads"],
        hidden_dim=hf["hidden_dim"],
        max_position_embeddings=hf.get("max_position_embeddings", 512),
        pad_token_id=hf.get("pad_token_id", 0),
        initializer_range=hf.get("initializer_range", 0.02),
        gelu="tanh" if activation in ("gelu_new", "gelu_pytorch_tanh") else "exact",
    )
    kw.update(overrides)
    kw.setdefault("max_len", min(128, kw["max_position_embeddings"]))
    return ModelConfig(**kw)


def load_hf_dir(
    path: str, cfg: ModelConfig | None = None, head_rng: np.random.Generator | None = None
) -> tuple[dict[str, torch.Tensor], ModelConfig]:
    """An HF DistilBERT checkpoint directory (``config.json`` + weights in
    ``model.safetensors`` or ``pytorch_model.bin``) -> ``(state dict,
    model config)``; ``cfg`` pins the non-architecture knobs."""
    if cfg is None:
        cfg = config_from_hf_dir(path)
    return hf_to_port(_load_weights(path), cfg, head_rng=head_rng), cfg


def load_reference_pth(path: str, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """A reference-run ``.pth`` (``torch.save`` of its DDoSClassifier state
    dict, client1.py:388; server.py:77) -> the port's state dict: the
    migration path of a model the reference trained. A dict without the
    trained head is refused rather than given a random one."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not any(str(k).startswith("classifier.") for k in sd):
        raise ValueError(
            f"{path} has no classifier.* keys — not a reference training "
            "artifact (expected its DDoSClassifier state dict, "
            "client1.py:53-58)"
        )
    return hf_to_port(sd, cfg)


def write_hf_dir(out: str, params: Mapping[str, torch.Tensor], cfg: ModelConfig, tok) -> dict[str, np.ndarray]:
    """Write ``config.json``, ``model.safetensors`` and ``vocab.txt`` under
    ``out`` (the layout ``DistilBertModel.from_pretrained`` and ``--hf-dir``
    read, with the JAX export's config fields); returns the tensors."""
    sd = port_to_hf(params, cfg)
    os.makedirs(out, exist_ok=True)
    st.save_file(sd, os.path.join(out, ST_FILE))
    hf_config = {
        "architectures": ["DistilBertModel"],
        "model_type": "distilbert",
        "vocab_size": cfg.vocab_size,
        "dim": cfg.dim,
        "n_layers": cfg.n_layers,
        "n_heads": cfg.n_heads,
        "hidden_dim": cfg.hidden_dim,
        "max_position_embeddings": cfg.max_position_embeddings,
        "dropout": cfg.dropout,
        "attention_dropout": cfg.attention_dropout,
        "pad_token_id": cfg.pad_token_id,
        "initializer_range": cfg.initializer_range,
        # The activation the weights were trained under: HF's "gelu" is
        # the erf form, "gelu_new" the tanh form.
        "activation": "gelu" if cfg.gelu == "exact" else "gelu_new",
        "tie_weights_": True,
    }
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(hf_config, f, indent=2)
    tok.save_vocab(os.path.join(out, "vocab.txt"))
    return sd
