"""Model configuration for the PyTorch port.

Copies of the JAX package's ``ModelConfig``, ``DataConfig`` and
``TrainConfig`` (fields, defaults, validation and presets unchanged), so a
manifest or config written by either package means the same thing in
both. Fields whose code paths the port has not reached yet (FedProx,
gradient accumulation, the non-``sample`` partitions) are kept for
compatibility and raise ``NotImplementedError`` when set away from their
defaults, instead of being ignored. ``ExperimentConfig`` carries only the
sections the ported commands read.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    """Transformer encoder + classification head.

    Defaults reproduce DistilBERT-base-uncased (6 layers, 768 hidden, 12 heads,
    3072 FFN, learned positions, post-LayerNorm, exact GELU) which the reference
    loads via HF ``DistilBertModel.from_pretrained`` (reference client1.py:56),
    plus the reference's classifier head: CLS pooling -> Dropout(0.3) ->
    Linear(768, 2) (reference client1.py:57-58,62-64).
    """

    vocab_size: int = 30522
    max_len: int = 128
    max_position_embeddings: int = 512  # HF DistilBERT position-table size
    dim: int = 768
    n_layers: int = 6
    n_heads: int = 12
    hidden_dim: int = 3072
    dropout: float = 0.1
    attention_dropout: float = 0.1
    head_dropout: float = 0.3
    n_classes: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    pad_token_id: int = 0
    # Activations run in compute_dtype (bf16 on the card); params stay fp32.
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # FFN activation: "tanh" is the GPT-2-style tanh GELU, within a few
    # bf16 ulps (<0.8% relative) of the erf form.
    # "exact" is HF DistilBERT's erf GELU (reference client1.py:56 via HF);
    # use it for fp32 logit-parity comparisons (ModelConfig.tiny defaults
    # to it alongside fp32 compute).
    gelu: str = "tanh"
    # "dot" (plain PyTorch attention), "flash" (the hand-written kernel,
    # ops/flash_attention.py), "ring" (sequence-parallel; not ported yet).
    attention_impl: str = "dot"
    # Compute Q/K/V with ONE [D, 3D] matmul over weights concatenated at
    # apply time (the parameter layout keeps separate q/k/v, so
    # checkpoints are unaffected).
    fused_qkv: bool = False
    # Mesh axis names of the sequence-parallel path; kept so manifests
    # written by the JAX package load unchanged.
    ring_axis: str = "seq"
    data_axis: str = "data"
    remat: bool = False

    def __post_init__(self) -> None:
        if self.n_layers < 1:
            raise ValueError(f"n_layers={self.n_layers} must be >= 1")
        if self.max_len > self.max_position_embeddings:
            raise ValueError(
                f"max_len={self.max_len} exceeds the position-embedding table "
                f"(max_position_embeddings={self.max_position_embeddings}); "
                "position indices would run off the table"
            )
        if self.attention_impl not in ("dot", "flash", "ring"):
            raise ValueError(f"unknown attention_impl {self.attention_impl!r}")
        if self.gelu not in ("exact", "tanh"):
            raise ValueError(f"unknown gelu {self.gelu!r} (exact|tanh)")

    @property
    def head_dim(self) -> int:
        if self.dim % self.n_heads:
            raise ValueError(f"dim={self.dim} not divisible by n_heads={self.n_heads}")
        return self.dim // self.n_heads

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def distilbert_base(cls, **kw: Any) -> "ModelConfig":
        return cls(**kw)

    @classmethod
    def bert_base(cls, **kw: Any) -> "ModelConfig":
        """BERT-base-sized scale-up encoder (BASELINE.json config 4)."""
        kw.setdefault("n_layers", 12)
        return cls(**kw)

    @classmethod
    def bert_large(cls, **kw: Any) -> "ModelConfig":
        """BERT-large-sized encoder (24L/1024/16H/4096, ~335 M params)."""
        kw.setdefault("n_layers", 24)
        kw.setdefault("dim", 1024)
        kw.setdefault("n_heads", 16)
        kw.setdefault("hidden_dim", 4096)
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw: Any) -> "ModelConfig":
        """Small config for tests / CI on CPU."""
        kw.setdefault("vocab_size", 256)
        kw.setdefault("max_len", 32)
        kw.setdefault("max_position_embeddings", 64)
        kw.setdefault("dim", 32)
        kw.setdefault("n_layers", 2)
        kw.setdefault("n_heads", 2)
        kw.setdefault("hidden_dim", 64)
        kw.setdefault("compute_dtype", "float32")
        kw.setdefault("gelu", "exact")  # fp32 tests compare against HF erf
        return cls(**kw)


@dataclass(frozen=True)
class DataConfig:
    """CICIDS2017-style flow CSV -> text -> token arrays.

    Mirrors reference semantics: ``±inf -> NaN -> column-mean`` imputation and a
    ``frac`` sample with a per-client seed (reference client1.py:84-93, seed 42;
    client2.py:79-88, seed 43), 60/20/20 split via two chained train_test_split
    calls (reference client1.py:365-366), label map ``'DDoS' -> 1 else 0``
    (reference client1.py:91).
    """

    csv_path: str = "CICIDS2017.csv"
    # Registered dataset schema; the port renders cicids2017 only so far.
    dataset: str = "cicids2017"
    data_fraction: float = 0.1
    seed_base: int = 42  # client i uses seed_base + i  (42, 43, ... — matches reference)
    val_fraction: float = 0.2
    test_fraction: float = 0.2
    label_column: str = "Label"
    positive_label: str = "DDoS"
    max_len: int = 128
    batch_size: int = 16
    eval_batch_size: int = 16
    # "sample" — reference behavior: independent frac-sample per client
    # seed. "disjoint" | "dirichlet" | "quantity" are the JAX package's
    # other schemes, not ported yet.
    partition: str = "sample"
    dirichlet_alpha: float = 0.5
    vocab_path: str | None = None
    # True drops each epoch's final short training batch (one batch shape);
    # eval always counts every example via row masks.
    drop_remainder: bool = True

    def __post_init__(self) -> None:
        if self.dirichlet_alpha <= 0.0:
            raise ValueError(
                f"dirichlet_alpha={self.dirichlet_alpha} must be > 0"
            )
        if self.partition not in ("sample", "disjoint", "dirichlet", "quantity"):
            raise ValueError(
                f"unknown partition scheme {self.partition!r} "
                "(sample|disjoint|dirichlet|quantity)"
            )
        if self.partition != "sample":
            raise NotImplementedError(
                f"partition={self.partition!r} is not ported yet (sample only)"
            )
        if self.dataset != "cicids2017":
            raise NotImplementedError(
                f"dataset={self.dataset!r} is not ported yet (cicids2017 only)"
            )

    def client_seed(self, client_id: int) -> int:
        return self.seed_base + client_id


@dataclass(frozen=True)
class TrainConfig:
    """Local-training hyperparameters (reference client1.py:370,379-380)."""

    learning_rate: float = 2e-5
    # Linear LR warmup over this many GLOBAL steps (0 = constant).
    warmup_steps: int = 0
    epochs_per_round: int = 3
    weight_decay: float = 0.0
    grad_accum_steps: int = 1
    max_grad_norm: float | None = None
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    seed: int = 0
    # Every N train steps the fit loop logs step, loss and samples/s (one
    # device sync each); 0 disables.
    log_every: int = 100
    # The JAX package's dropout-key PRNG; kept so its configs load. The
    # port draws dropout from torch.Generators and does not read it.
    prng_impl: str = "rbg"
    # "all" trains every parameter; "head" freezes the encoder and trains
    # only the classifier head.
    trainable: str = "all"
    # FedProx proximal term of the TCP client loop (not ported yet).
    prox_mu: float = 0.0

    def __post_init__(self) -> None:
        if self.prng_impl not in ("rbg", "threefry2x32", "unsafe_rbg"):
            raise ValueError(f"unknown prng_impl {self.prng_impl!r}")
        if self.trainable not in ("all", "head"):
            raise ValueError(
                f"trainable={self.trainable!r} must be 'all' or 'head'"
            )
        if self.prox_mu < 0.0:
            raise ValueError(f"prox_mu={self.prox_mu} must be >= 0")
        if self.prox_mu > 0.0:
            raise NotImplementedError("prox_mu > 0 (FedProx) is not ported yet")
        if self.grad_accum_steps != 1:
            raise NotImplementedError(
                "grad_accum_steps > 1 (gradient accumulation) is not ported yet"
            )


@dataclass(frozen=True)
class ExperimentConfig:
    """The sections of the JAX package's ``ExperimentConfig`` that the
    ported commands read."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    output_dir: str = "outputs"

    def __post_init__(self) -> None:
        if self.data.max_len != self.model.max_len:
            raise ValueError(
                f"data.max_len={self.data.max_len} != model.max_len="
                f"{self.model.max_len}"
            )
