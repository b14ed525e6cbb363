"""Model configuration for the PyTorch port.

Copies of the JAX package's ``ModelConfig``, ``DataConfig`` and
``TrainConfig`` (fields, defaults, validation and presets unchanged) and
its ``FedConfig``, ``MeshConfig``, ``DistillConfig``, ``ObsConfig`` and
``ControlConfig``, so a manifest or config written by either package
means the same thing in both. Every field reaches a code path of the
port but one: ``MeshConfig.seq > 1`` (the sequence-parallel axis, item
15) raises ``NotImplementedError`` instead of being ignored. A checkpoint
records ``ExperimentConfig`` as ``to_dict()`` and ``predict`` reads it
back with ``from_dict``, which also reads a config the JAX package
wrote, section for section and field for field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping


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
    # Registered dataset schema: cicids2017 | cicddos2019 | unswnb15 |
    # cicddos2019-mc (data/datasets.py). Governs the text template and the
    # label semantics.
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
    # "sample"    — reference behavior: independent frac-sample per client
    #               seed (overlap between clients possible).
    # "disjoint"  — equal disjoint shards.
    # "dirichlet" — non-IID label skew; "quantity" — disjoint IID shards
    #               with Dirichlet(alpha) sizes (data/partition.py).
    partition: str = "sample"
    # Concentration for both skewed schemes; smaller = more skewed.
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
        from .data.datasets import get_dataset

        get_dataset(self.dataset)  # an unknown name raises ValueError

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
    # optax.MultiSteps over this many micro steps (train/engine.py): one
    # optimizer update per k batches, on the running mean of their grads.
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
    # FedProx proximal term of the TCP client loop (train/engine.py); the
    # single-process federated trainer reads FedConfig.prox_mu.
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


@dataclass(frozen=True)
class FedConfig:
    """Federated-round structure (the JAX package's ``FedConfig``: fields,
    defaults and validation).

    The reference runs one FedAvg round per invocation with exactly two
    clients and an unweighted mean (reference server.py:13,67-79); here
    rounds and client count are first-class, the mean may be weighted by
    sample count, dropped clients are masked out of it, DP-FedAvg clips
    and noises it, and personalization fine-tunes each client after the
    last round.
    """

    num_clients: int = 2
    rounds: int = 1
    # None = auto: weight by sample count whenever the counts are known
    # and DP is off; True requires the weights, False forces the uniform
    # mean (the reference's server.py:73-76).
    weighted: bool | None = None
    # FedProx (Li et al.): local loss += mu/2 * ||w - w_round_start||^2.
    prox_mu: float = 0.0
    # Survivors (of crashes and empty shards) needed for a round to
    # aggregate.
    min_client_fraction: float = 1.0
    # A fresh Adam each round, as every reference re-launch builds one
    # (client1.py:380).
    reset_optimizer_each_round: bool = True
    # Fraction of clients aggregated per round (sampled, seeded).
    participation: float = 1.0
    # Cohort sampler under participation < 1: "fixed" (exactly
    # cohort_size() clients), "poisson" (each client independently), or
    # "auto" (poisson when DP is on, fixed otherwise).
    participation_mode: str = "auto"
    # DP-FedAvg (parallel/dp.py): each client's round update is clipped to
    # L2 norm dp_clip, and noise of std dp_noise_multiplier * dp_clip / n
    # joins the uniform mean. dp_seed pins the noise for tests only:
    # anyone who knows it can subtract the noise, so it voids the
    # guarantee; None draws fresh OS entropy each run.
    dp_clip: float = 0.0
    dp_noise_multiplier: float = 0.0
    dp_seed: int | None = None
    # FedOpt server optimizer over the round's mean update: "none" (plain
    # FedAvg), "momentum" (FedAvgM), "adam" (FedAdam), "yogi" (FedYogi).
    # Its state persists across rounds.
    server_opt: str = "none"
    server_lr: float = 1.0
    server_momentum: float = 0.9
    # Personalization after the final round: each client fine-tunes the
    # aggregate on its own shard for personalize_epochs (0 = off), scope
    # "full" (FedAvg+FT) or "head" (FedPer: the encoder stays frozen), and
    # is evaluated as a third "personalized" phase.
    personalize_epochs: int = 0
    personalize_scope: str = "full"
    # Relay subtree deadline as a fraction of the round timeout (the
    # ``relay --subtree-deadline-factor``), and the streamed-upload wire
    # dtype (the client's --wire-dtype flag drives the client).
    subtree_deadline_factor: float = 0.5
    wire_dtype: str = "fp32"

    def server_opt_enabled(self) -> bool:
        return self.server_opt != "none"

    def resolve_weighted(self) -> bool:
        """The effective weighting: auto (None) weights by sample count
        unless DP needs its uniform mean."""
        if self.weighted is None:
            return self.dp_clip == 0.0
        return self.weighted

    def cohort_size(self) -> int:
        """Clients sampled per round: ``ceil(C * participation)``, at
        least 1 (ceil keeps a sampled round above min_client_fraction)."""
        import math

        if self.participation >= 1.0:
            return self.num_clients
        return min(
            self.num_clients,
            max(1, math.ceil(self.num_clients * self.participation)),
        )

    def effective_participation(self) -> float:
        """The actual per-round sampling rate ``cohort_size / C``."""
        return self.cohort_size() / self.num_clients

    def dp_enabled(self) -> bool:
        return self.dp_clip > 0.0 and self.dp_noise_multiplier > 0.0

    def resolve_participation_mode(self) -> str:
        """The effective cohort sampler ("fixed" when everyone takes
        part; "auto" is poisson under DP, fixed otherwise)."""
        if self.participation >= 1.0:
            return "fixed"
        if self.participation_mode == "auto":
            return "poisson" if self.dp_enabled() else "fixed"
        return self.participation_mode

    def dp_sampling_rate(self) -> tuple[float, bool]:
        """(q for the DP accountant, whether the SGM bound's sampling
        assumption is exact for the sampler in use). Poisson: q is the
        nominal participation, the sampler's own Bernoulli rate. Fixed:
        q = cohort_size / C, the standard approximation."""
        if self.participation >= 1.0:
            return 1.0, True
        if self.resolve_participation_mode() == "poisson":
            return self.participation, True
        return self.effective_participation(), False

    def __post_init__(self) -> None:
        if not 0.0 < self.participation <= 1.0:
            raise ValueError(
                f"participation={self.participation} must be in (0, 1]"
            )
        if self.participation_mode not in ("auto", "fixed", "poisson"):
            raise ValueError(
                f"participation_mode={self.participation_mode!r} must be "
                "'auto', 'fixed' or 'poisson'"
            )
        if self.personalize_epochs < 0:
            raise ValueError(
                f"personalize_epochs={self.personalize_epochs} must be >= 0"
            )
        if self.personalize_scope not in ("full", "head"):
            raise ValueError(
                f"personalize_scope={self.personalize_scope!r} must be "
                "'full' or 'head'"
            )
        if not 0.0 < self.subtree_deadline_factor < 1.0:
            raise ValueError(
                f"subtree_deadline_factor={self.subtree_deadline_factor} "
                "must be in (0, 1)"
            )
        if self.wire_dtype not in ("fp32", "bf16", "int8"):
            raise ValueError(
                f"wire_dtype={self.wire_dtype!r} must be "
                "'fp32', 'bf16' or 'int8'"
            )
        if self.participation < self.min_client_fraction:
            raise ValueError(
                f"participation={self.participation} below "
                f"min_client_fraction={self.min_client_fraction}: every "
                "round would fail its own survivor check"
            )
        if self.dp_clip < 0.0:
            raise ValueError(f"dp_clip={self.dp_clip} must be >= 0")
        if self.dp_noise_multiplier < 0.0:
            raise ValueError(
                f"dp_noise_multiplier={self.dp_noise_multiplier} must be >= 0"
            )
        if self.dp_noise_multiplier > 0.0 and self.dp_clip == 0.0:
            raise ValueError(
                "dp_noise_multiplier > 0 requires dp_clip > 0: the noise "
                "std is calibrated to the clip norm (sensitivity)"
            )
        if self.dp_clip > 0.0 and self.weighted:
            raise ValueError(
                "dp_clip > 0 is incompatible with weighted FedAvg: the DP "
                "sensitivity bound assumes a uniform mean over participants"
            )
        if self.server_opt not in ("none", "momentum", "adam", "yogi"):
            raise ValueError(
                f"unknown server_opt {self.server_opt!r} "
                "(none|momentum|adam|yogi)"
            )
        if self.server_lr <= 0.0:
            raise ValueError(f"server_lr={self.server_lr} must be > 0")
        if not 0.0 <= self.server_momentum < 1.0:
            raise ValueError(
                f"server_momentum={self.server_momentum} must be in [0, 1)"
            )


@dataclass(frozen=True)
class DistillConfig:
    """Knowledge distillation, teacher -> student (train/distill.py).

    Loss = alpha * T^2 * KL(teacher_T || student_T) + (1 - alpha) *
    CE(labels); with ``init_from_teacher`` the student starts from
    evenly strided teacher layers (the DistilBERT init: 12 -> 6 takes
    every other one). The stride is ``teacher_layers // student_layers``;
    widths must match (depth-only distillation).
    """

    temperature: float = 2.0
    alpha: float = 0.5
    init_from_teacher: bool = True

    def __post_init__(self) -> None:
        if not 0.0 <= self.alpha <= 1.0:
            raise ValueError(f"alpha={self.alpha} must be in [0, 1]")
        if self.temperature <= 0.0:
            raise ValueError(f"temperature={self.temperature} must be > 0")


@dataclass(frozen=True)
class ObsConfig:
    """Observability (obs/): cross-tier round tracing + /metrics (the JAX
    package's section, field for field, so a config file of either
    package resolves to the same values). The matching CLI flags
    (``--trace-jsonl``, ``--metrics-port``, ``--flight-dir``,
    ``--profile-stride``, ``--trace-sample``) override per process. The
    snapshot and sentinel knobs configure the JAX package's fleet read
    side, which the port does not run; they are kept so the section
    round-trips.
    """

    #: Span events-JSONL path for THIS process (obs.trace.Tracer). None
    #: (default) = tracing off. Give every process its own file; `fedtpu
    #: obs timeline --trace-dir` merges a directory of them.
    trace_jsonl: str | None = None
    #: Prometheus text endpoint port (stdlib HTTP, GET /metrics). 0
    #: (default) = off — the endpoint binds nothing unless asked.
    metrics_port: int = 0
    #: Run identity stamped on every span and metrics record. None =
    #: FEDTPU_RUN_ID env var, else a fresh per-process id.
    run_id: str | None = None
    #: Span sampling rate for HIGH-RATE span streams (today: the serving
    #: tier's per-coalesced-batch ``serve-batch`` spans): emit one span
    #: per ~1/rate batches via a deterministic batch-counter stride (no
    #: RNG — reruns sample identically), each carrying
    #: ``sampled_batches`` so consumers can re-scale. 1.0 = every batch.
    #: Round-scoped spans (round/agg/wire-*) are never sampled — they
    #: are one-per-round by construction.
    trace_sample: float = 1.0
    #: Failure flight recorder (obs/flight.py): postmortem bundles land
    #: in this directory on round failure / eject storm / SLO page.
    #: None (default) = recorder off — no ring, no hot-path cost. The
    #: matching CLI flag is ``--flight-dir``.
    flight_dir: str | None = None
    #: Span-ring depth the flight recorder retains per process.
    flight_ring: int = 256
    #: Device performance plane (obs/profile.py): sample every Nth
    #: train/score step with fenced host/dispatch/device timers
    #: (``fedtpu_*_step_seconds`` histograms + span attrs). 0 (default)
    #: = off — the hot loops run the literal unprofiled path (no
    #: fences, no timer reads). The matching CLI flag is
    #: ``--profile-stride``; a deterministic counter stride, no RNG.
    profile_stride: int = 0
    #: Snapshot-JSONL retention cap in MB for the scrape hub / sentinel
    #: (``--snapshot-max-mb``): past this size the live file atomically
    #: rolls to ``<path>.1`` (at most ~2x the cap on disk). None
    #: (default) = unbounded, the pre-existing behavior.
    snapshot_max_mb: float | None = None
    #: Sentinel cadence (obs/sentinel.py): seconds between ticks of the
    #: ``fedtpu obs sentinel`` watch loop.
    sentinel_interval_s: float = 5.0
    #: Long-horizon retention ring rows kept (memory + --ring-jsonl).
    sentinel_ring_records: int = 512
    #: Ring rows pinned as the regression baseline window (the FIRST N
    #: retained — "how the fleet looked when watching began").
    sentinel_baseline_n: int = 8
    #: Current-window rows a trend check averages against the baseline.
    sentinel_window_n: int = 8
    #: A watched field regresses when its current-window mean moves past
    #: baseline * ratio (+ the field's absolute floor); round cadence
    #: fires on the inverse drop.
    sentinel_regression_ratio: float = 1.5

    def __post_init__(self) -> None:
        if not 0 <= self.metrics_port <= 65535:
            raise ValueError(
                f"metrics_port={self.metrics_port} must be a port in "
                "[0, 65535] (0 = off)"
            )
        if not 0.0 < self.trace_sample <= 1.0:
            raise ValueError(
                f"trace_sample={self.trace_sample} must be in (0, 1]"
            )
        if self.flight_ring < 1:
            raise ValueError(
                f"flight_ring={self.flight_ring} must be >= 1"
            )
        if self.profile_stride < 0:
            raise ValueError(
                f"profile_stride={self.profile_stride} must be >= 0 "
                "(0 = off)"
            )
        if self.snapshot_max_mb is not None and self.snapshot_max_mb <= 0:
            raise ValueError(
                f"snapshot_max_mb={self.snapshot_max_mb} must be > 0 "
                "(None = unbounded)"
            )
        if self.sentinel_interval_s <= 0:
            raise ValueError(
                f"sentinel_interval_s={self.sentinel_interval_s} must "
                "be > 0"
            )
        if self.sentinel_ring_records < max(
            self.sentinel_baseline_n, self.sentinel_window_n
        ):
            raise ValueError(
                f"sentinel_ring_records={self.sentinel_ring_records} "
                "must hold at least the baseline "
                f"({self.sentinel_baseline_n}) and current "
                f"({self.sentinel_window_n}) windows"
            )
        if self.sentinel_regression_ratio <= 1.0:
            raise ValueError(
                f"sentinel_regression_ratio="
                f"{self.sentinel_regression_ratio} must be > 1 (it "
                "multiplies the baseline mean)"
            )


@dataclass(frozen=True)
class ControlConfig:
    """Control-plane loop (control/ + registry/): the knobs of the
    unattended train -> gate -> promote -> serve -> monitor cycle.

    The reference has no loop at all — a round happens when a human
    re-runs three scripts, and nothing gates what the serving tier loads.
    """

    # Eval gate: a candidate must score >= incumbent[metric] - min_delta
    # on the held-out split or it is rejected (the serving pointer stays
    # on the incumbent — automatic rollback-by-refusal).
    gate_metric: str = "Accuracy"
    gate_min_delta: float = 0.0
    # Round cadence. min_interval_s throttles back-to-back rounds;
    # max_interval_s forces a round even when no drift fired (None = no
    # clock at all — purely drift-triggered once a monitor is attached).
    min_interval_s: float = 0.0
    max_interval_s: float | None = None
    # Drift monitor (control/drift.py): score-distribution shift of live
    # serving traffic vs the promoted artifact's eval reference
    # histogram. PSI > 0.25 is the classic "significant shift" bound.
    drift_method: str = "psi"  # psi | ks
    drift_threshold: float = 0.25
    drift_min_scores: int = 256
    # Histogram resolution for both the eval reference and the serving
    # tier's score export; both sides must agree.
    score_bins: int = 10
    # Per-round deadline handed to the TCP round engine (None = the
    # server's own timeout).
    round_deadline_s: float | None = None
    # Registry GC budget: after every promotion/rejection the controller
    # prunes oldest RETIRED/REJECTED artifacts beyond this count (the
    # serving artifact and its rollback chain are never pruned —
    # registry/store.py gc()). None (default) keeps everything.
    max_artifacts: int | None = None
    # Adaptive cadence (control/drift.py cadence_interval_s): a fired
    # drift verdict's MAGNITUDE scales the next inter-round interval
    # between min_interval_s (drift >= 2x threshold: urgent) and
    # max_interval_s (barely over threshold: relaxed). Needs both bounds
    # configured; the chosen interval rides the drift-trigger span.
    adaptive_cadence: bool = False
    # SLO-driven actuation: while a round-duration burn alert FIRES on
    # the tailed alerts-JSONL (controller --slo-alerts-jsonl), the
    # round's straggler deadline is multiplied by this factor — a fleet
    # already blowing its round SLO should cut stragglers loose sooner,
    # not wait the full budget on them. 1.0 disables the tightening.
    slo_deadline_factor: float = 0.5
    # Drift-scaled cohort (control/drift.py drift_cohort_fraction): a
    # fired drift verdict's MAGNITUDE picks the corrective round's
    # quorum between cohort_min_frac (barely over threshold: a lean,
    # fast cohort) and cohort_max_frac (>= 2x threshold: the full
    # quorum's evidence) of the server's configured min_clients — for
    # ONE round, then the base quorum restores.
    drift_cohort: bool = False
    cohort_min_frac: float = 0.5
    cohort_max_frac: float = 1.0

    def __post_init__(self) -> None:
        if not 0.0 < self.slo_deadline_factor <= 1.0:
            raise ValueError(
                f"slo_deadline_factor={self.slo_deadline_factor} must be "
                "in (0, 1] (1 = no tightening)"
            )
        if self.max_artifacts is not None and self.max_artifacts < 1:
            raise ValueError(
                f"max_artifacts={self.max_artifacts} must be >= 1 "
                "(or None to keep everything)"
            )
        if self.drift_method not in ("psi", "ks"):
            raise ValueError(
                f"drift_method={self.drift_method!r} must be 'psi' or 'ks'"
            )
        if self.drift_threshold <= 0.0:
            raise ValueError(
                f"drift_threshold={self.drift_threshold} must be > 0"
            )
        if self.drift_min_scores < 1:
            raise ValueError(
                f"drift_min_scores={self.drift_min_scores} must be >= 1"
            )
        if not 2 <= self.score_bins <= 64:
            # Upper bound matches the metrics-JSONL short-list cap
            # (reporting.append_metrics_jsonl keeps lists <= 64 entries):
            # a larger histogram would be silently dropped from every
            # serve_batch record and starve the drift monitor.
            raise ValueError(
                f"score_bins={self.score_bins} must be in [2, 64]"
            )
        if self.min_interval_s < 0.0:
            raise ValueError(
                f"min_interval_s={self.min_interval_s} must be >= 0"
            )
        if (
            self.max_interval_s is not None
            and self.max_interval_s < self.min_interval_s
        ):
            raise ValueError(
                f"max_interval_s={self.max_interval_s} below "
                f"min_interval_s={self.min_interval_s}"
            )
        if not 0.0 < self.cohort_min_frac <= 1.0:
            raise ValueError(
                f"cohort_min_frac={self.cohort_min_frac} must be in (0, 1]"
            )
        if not 0.0 < self.cohort_max_frac <= 1.0:
            raise ValueError(
                f"cohort_max_frac={self.cohort_max_frac} must be in (0, 1]"
            )
        if self.cohort_max_frac < self.cohort_min_frac:
            raise ValueError(
                f"cohort_max_frac={self.cohort_max_frac} below "
                f"cohort_min_frac={self.cohort_min_frac}"
            )


@dataclass(frozen=True)
class LabelsConfig:
    """Delayed ground-truth plane (labels/): the journal of late-arriving
    verdicts about what each scored flow actually WAS, the deterministic
    join against what the models ANSWERED, and the supervised promotion
    rung the join feeds. The reference has no feedback path at all once
    a model serves — nothing ever tells it it was wrong."""

    #: Ground-truth journal override (default:
    #: ``<registry>/labels/journal.jsonl`` — labels/store.journal_path).
    journal: str | None = None
    #: Decision threshold the join applies to both models' probabilities.
    threshold: float = 0.5
    #: Minimum joined (labeled) flows before the supervised gate may
    #: rule; fewer FAILS CLOSED.
    min_joined: int = 32
    #: Minimum joined/total coverage of the scored population; below it
    #: the gate FAILS CLOSED (a verdict over a sliver is noise).
    coverage_floor: float = 0.05
    #: Max tolerated candidate-over-serving supervised error excess.
    max_regression: float = 0.0
    #: Supervised drift margin (control/drift.py ErrorRateMonitor): the
    #: serving model's joined error rising this far past its promoted
    #: reference fires a corrective round.
    error_margin: float = 0.05
    #: Joined observations the error monitor needs before it may fire.
    error_min_joined: int = 64

    def __post_init__(self) -> None:
        if not 0.0 < self.threshold < 1.0:
            raise ValueError(
                f"threshold={self.threshold} must be in (0, 1)"
            )
        if self.min_joined < 1:
            raise ValueError(f"min_joined={self.min_joined} must be >= 1")
        if not 0.0 <= self.coverage_floor <= 1.0:
            raise ValueError(
                f"coverage_floor={self.coverage_floor} must be in [0, 1]"
            )
        if self.max_regression < 0.0:
            raise ValueError(
                f"max_regression={self.max_regression} must be >= 0"
            )
        if self.error_margin <= 0.0:
            raise ValueError(
                f"error_margin={self.error_margin} must be > 0"
            )
        if self.error_min_joined < 1:
            raise ValueError(
                f"error_min_joined={self.error_min_joined} must be >= 1"
            )


@dataclass(frozen=True)
class ShadowConfig:
    """Shadow evaluation plane (shadow/): mirror a sampled fraction of
    live scoring traffic onto the registry's ``shadow``-state artifact
    and gate promotion on the measured live disagreement instead of
    offline eval alone. The reference (and the pre-shadow controller)
    promotes on held-out metrics only — exactly the gate that misses
    live-distribution drift."""

    #: Mirror stride: duplicate one live request in ``sample`` onto the
    #: shadow backend (deterministic counter stride, no RNG — the
    #: serve-batch trace-sampling discipline). 0 = shadow plane off.
    sample: int = 0
    #: Minimum mirrored pairs before the gate may rule; fewer at timeout
    #: FAILS CLOSED (the candidate is rejected, the pointer never moves).
    min_pairs: int = 256
    #: Max tolerated fraction of pairs whose thresholded prediction
    #: flipped between serving and shadow.
    max_flip_rate: float = 0.02
    #: Max tolerated PSI between the paired serving/shadow score
    #: histograms (the drift monitor's distance, same 0.25 lore).
    psi_threshold: float = 0.25
    #: Gate patience: how long the controller waits for the evidence.
    timeout_s: float = 600.0
    #: Seconds between the gate's status polls.
    poll_s: float = 0.5
    #: Prediction threshold the flip comparison applies on both sides.
    threshold: float = 0.5
    #: Histogram bins for the paired score distributions (must match the
    #: drift tier's resolution so PSI thresholds transfer).
    bins: int = 10
    #: Mirror queue bound: a full queue drops the mirror COPY — never
    #: delays or fails the live request.
    queue: int = 256

    def __post_init__(self) -> None:
        if self.sample < 0:
            raise ValueError(f"sample={self.sample} must be >= 0 (0 = off)")
        if self.min_pairs < 1:
            raise ValueError(f"min_pairs={self.min_pairs} must be >= 1")
        if not 0.0 <= self.max_flip_rate <= 1.0:
            raise ValueError(
                f"max_flip_rate={self.max_flip_rate} must be in [0, 1]"
            )
        if self.psi_threshold <= 0.0:
            raise ValueError(
                f"psi_threshold={self.psi_threshold} must be > 0"
            )
        if self.timeout_s <= 0.0:
            raise ValueError(f"timeout_s={self.timeout_s} must be > 0")
        if self.poll_s <= 0.0:
            raise ValueError(f"poll_s={self.poll_s} must be > 0")
        if not 0.0 < self.threshold < 1.0:
            raise ValueError(
                f"threshold={self.threshold} must be in (0, 1)"
            )
        if not 2 <= self.bins <= 64:
            raise ValueError(f"bins={self.bins} must be in [2, 64]")
        if self.queue < 1:
            raise ValueError(f"queue={self.queue} must be >= 1")


@dataclass(frozen=True)
class RouterConfig:
    """Serving replica fleet (router/): the knobs of the thin router and
    the rolling hot-reload manager behind ``fedtpu route`` / ``fedtpu
    fleet``. The reference serves nothing at all; the single-process
    ``infer-serve`` tier serves from one scorer — these knobs govern the
    tier that scales past it."""

    #: Local replicas ``fedtpu fleet`` spawns behind the router.
    replicas: int = 3
    #: Seconds between in-band stats() health probes per replica.
    probe_interval_s: float = 1.0
    #: Unanswered-probe age that ejects a replica from the pick set.
    probe_timeout_s: float = 5.0
    #: Rolling reload: how long to wait for one replica's in-flight
    #: requests to finish before swapping anyway.
    drain_timeout_s: float = 30.0
    #: Seconds between serving-pointer polls by the fleet manager.
    reload_poll_s: float = 2.0
    #: Router-side admission bound: a replica at this many in-flight
    #: requests leaves the pick set until replies drain it.
    max_inflight_per_replica: int = 1024

    def __post_init__(self) -> None:
        if self.replicas < 1:
            raise ValueError(f"replicas={self.replicas} must be >= 1")
        if self.probe_interval_s <= 0.0:
            raise ValueError(
                f"probe_interval_s={self.probe_interval_s} must be > 0"
            )
        if self.probe_timeout_s <= 0.0:
            raise ValueError(
                f"probe_timeout_s={self.probe_timeout_s} must be > 0"
            )
        if self.drain_timeout_s < 0.0:
            raise ValueError(
                f"drain_timeout_s={self.drain_timeout_s} must be >= 0"
            )
        if self.reload_poll_s <= 0.0:
            raise ValueError(
                f"reload_poll_s={self.reload_poll_s} must be > 0"
            )
        if self.max_inflight_per_replica < 1:
            raise ValueError(
                f"max_inflight_per_replica={self.max_inflight_per_replica} "
                "must be >= 1"
            )


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (the JAX package's ``MeshConfig``: fields,
    defaults and validation).

    axes: ``clients`` — federated replicas (the FedAvg mean rides this
    axis); ``data`` — per-client batch parallelism (gradients are summed
    over it). In the port a mesh is a grid of explicit device slots
    (:mod:`..parallel.mesh`); across processes, ``torch.distributed``
    (:mod:`..parallel.multihost`).
    """

    clients: int = 2
    data: int = 1
    # Sequence-parallel axis (ring attention): not ported yet (item 15);
    # > 1 raises NotImplementedError.
    seq: int = 1
    # FSDP shard-at-rest on the TCP client's local mesh (`client
    # --data-parallel N --fsdp`, train/client_mesh.py FsdpMeshTrainer):
    # params AND optimizer state split per-leaf over the `data` slots,
    # gathered at use; per-slot static bytes scale ~1/N. Trajectory
    # matches the replicated mesh to fp32 reduction-order ulps.
    fsdp: bool = False
    axis_names: tuple[str, str] = ("clients", "data")

    def __post_init__(self) -> None:
        if self.clients < 1 or self.data < 1:
            raise ValueError(
                f"mesh axes must be >= 1 (clients={self.clients}, "
                f"data={self.data})"
            )
        if self.seq < 1:
            raise ValueError(f"mesh.seq={self.seq} must be >= 1")
        if self.fsdp and self.data < 2:
            raise ValueError(
                "mesh.fsdp needs data >= 2 (--data-parallel N): sharding "
                "the static state over one device is a no-op"
            )
        if self.fsdp and self.seq > 1:
            raise ValueError(
                "mesh.fsdp does not compose with seq > 1: the C=1 fedseq "
                "trainer owns the 3-axis layout (sharded-scorer/fedseq "
                "FSDP is the ROADMAP follow-up)"
            )
        if self.seq > 1:
            raise NotImplementedError(
                f"mesh.seq={self.seq}: the sequence-parallel axis (ring "
                "attention) is not ported yet (ROADMAP item 15)"
            )


@dataclass(frozen=True)
class ExperimentConfig:
    """The JAX package's ``ExperimentConfig``, section for section.

    The JAX package also holds ``fed.num_clients`` to a multiple of
    ``mesh.clients``; the port does not, since its federated trainer fits
    the mesh's rows to the client count itself
    (:func:`..parallel.mesh.fit_clients_axis`), so every config the JAX
    package accepts reads here too."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    fed: FedConfig = dataclasses.field(default_factory=FedConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    distill: DistillConfig = dataclasses.field(default_factory=DistillConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    control: ControlConfig = dataclasses.field(default_factory=ControlConfig)
    router: RouterConfig = dataclasses.field(default_factory=RouterConfig)
    shadow: ShadowConfig = dataclasses.field(default_factory=ShadowConfig)
    labels: LabelsConfig = dataclasses.field(default_factory=LabelsConfig)
    output_dir: str = "outputs"
    # Where ``local``/``client`` save (and ``client`` warm-starts from),
    # and what ``predict``/``infer-serve`` restore.
    checkpoint_dir: str | None = None

    def __post_init__(self) -> None:
        if self.data.max_len != self.model.max_len:
            raise ValueError(
                f"data.max_len={self.data.max_len} != model.max_len="
                f"{self.model.max_len}"
            )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentConfig":
        """Inverse of :meth:`to_dict`, and the reader of a config the JAX
        package wrote; unknown sections or keys raise."""
        sections = {
            "model": ModelConfig, "data": DataConfig, "train": TrainConfig,
            "fed": FedConfig, "mesh": MeshConfig, "distill": DistillConfig, "obs": ObsConfig,
            "control": ControlConfig, "router": RouterConfig, "shadow": ShadowConfig,
            "labels": LabelsConfig,
        }
        scalars = ("output_dir", "checkpoint_dir")
        unknown_top = set(d) - set(sections) - set(scalars)
        if unknown_top:
            raise ValueError(f"unknown config sections: {sorted(unknown_top)}")

        def _mk(tp, key):
            sub = dict(d.get(key, {}))
            unknown = set(sub) - {f.name for f in dataclasses.fields(tp)}
            if unknown:
                raise ValueError(f"unknown {key} config keys: {sorted(unknown)}")
            # JSON round-trips tuples as lists; tuple-typed fields come
            # back as tuples, so frozen configs stay hashable and equal.
            for k, v in sub.items():
                if isinstance(v, list):
                    sub[k] = tuple(v)
            return tp(**sub)

        kw: dict[str, Any] = {key: _mk(tp, key) for key, tp in sections.items()}
        kw.update({k: d[k] for k in scalars if k in d})
        return cls(**kw)

    @classmethod
    def from_checkpoint_dict(cls, d: Mapping[str, Any]) -> "ExperimentConfig":
        """:meth:`from_dict` of a checkpoint's recorded config, with the
        defaults in force when it was saved: a config without a ``gelu``
        field predates it and was trained under the erf GELU, so the
        absent key means "exact", not today's "tanh"."""
        model = dict(d.get("model", {}))
        model.setdefault("gelu", "exact")
        return cls.from_dict({**d, "model": model})
