"""Dataset registry: CICIDS2017, CIC-DDoS2019, UNSW-NB15, and mixed corpora.

The port's copy of the JAX package's ``data/datasets.py``, without
pandas: a frame is a dict of equal-length numpy columns (see
:mod:`.cicids`). Each dataset is a :class:`DatasetSpec`: an English text
template over its flow columns (the feature-to-text trick of reference
client1.py:68-81, adapted per schema) plus its label semantics:

* ``cicids2017``     — ``Label == 'DDoS'`` -> 1 (reference client1.py:91);
* ``cicddos2019``    — the same CICFlowMeter schema with per-attack labels
  (``DrDoS_DNS``, ``Syn``, ...), so ``Label != 'BENIGN'`` -> 1;
* ``unswnb15``       — its own schema (dur/proto/service/spkts/...), with a
  0/1 ``label`` column;
* ``cicddos2019-mc`` — the CIC-DDoS2019 day with its attack classes kept:
  label -> index into ``classes`` (class 0 is BENIGN).

A :class:`Corpus` is the schema-erased form — texts, labels and per-row
source ids — which a mixed-dataset fleet partitions over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np

from .textualize import CICIDS_TEMPLATE, render_template

#: ``{column name: values}``, every column the same length.
Frame = Mapping[str, np.ndarray]

#: UNSW-NB15 text template over 10 of its 49 features, in the sentence
#: style of the CICIDS2017 template.
UNSW_TEMPLATE: tuple[tuple[str, str, str], ...] = (
    ("Protocol is ", "proto", ". "),
    ("Service is ", "service", ". "),
    ("Flow duration is ", "dur", " seconds. "),
    ("Source to destination packets are ", "spkts", ". "),
    ("Destination to source packets are ", "dpkts", ". "),
    ("Source to destination bytes are ", "sbytes", " bytes. "),
    ("Destination to source bytes are ", "dbytes", " bytes. "),
    ("Packet rate is ", "rate", " per second. "),
    ("Source load is ", "sload", " bits per second. "),
    ("Destination load is ", "dload", " bits per second."),
)


@dataclass(frozen=True)
class DatasetSpec:
    """One dataset's text template and label semantics."""

    name: str
    template: tuple[tuple[str, str, str], ...]
    label_column: str
    #: "positive"   — label == positive_value -> 1 (CICIDS2017)
    #: "not_benign" — label != benign_value -> 1 (multi-attack-class sets)
    #: "int"        — the label column is already 0/1
    #: "multiclass" — label -> index into ``classes``; the binary map
    #:                stays ``label != benign_value``
    label_kind: str
    positive_value: str = "DDoS"
    benign_value: str = "BENIGN"
    #: Ordered class vocabulary of a ``multiclass`` spec; class 0 is the
    #: benign value (every consumer binarizes as ``!= 0``).
    classes: tuple[str, ...] | None = None

    def render_texts(self, frame: Frame) -> list[str]:
        missing = [c for _, c, _ in self.template if c not in frame]
        if missing:
            raise KeyError(
                f"dataset {self.name!r}: CSV is missing template columns "
                f"{missing} (have {list(frame)[:8]}...)"
            )
        return render_template(frame, self.template)

    def binary_labels(
        self,
        frame: Frame,
        *,
        label_column: str | None = None,
        positive_value: str | None = None,
    ) -> np.ndarray:
        col = label_column or self.label_column
        if col not in frame:
            raise KeyError(f"dataset {self.name!r}: no label column {col!r}")
        values = np.asarray(frame[col])
        if self.label_kind == "positive":
            return (values == (positive_value or self.positive_value)).astype(np.int32)
        if self.label_kind in ("not_benign", "multiclass"):
            return (values != self.benign_value).astype(np.int32)
        if self.label_kind == "int":
            return values.astype(np.int32)
        raise ValueError(f"unknown label_kind {self.label_kind!r}")

    def class_labels(self, frame: Frame) -> np.ndarray:
        """K-class label indices into ``classes`` (``multiclass`` specs).
        A label outside the declared vocabulary raises."""
        if self.label_kind != "multiclass" or not self.classes:
            raise ValueError(f"dataset {self.name!r} is not a multiclass spec")
        col = self.label_column
        if col not in frame:
            raise KeyError(f"dataset {self.name!r}: no label column {col!r}")
        index = {v: i for i, v in enumerate(self.classes)}
        values = [str(v) for v in np.asarray(frame[col]).tolist()]
        stray = sorted({v for v in values if v not in index})
        if stray:
            raise ValueError(
                f"dataset {self.name!r}: labels {stray[:8]} not in the "
                f"declared class vocabulary {list(self.classes)}"
            )
        return np.array([index[v] for v in values], dtype=np.int32)

    def labels(self, frame: Frame) -> np.ndarray:
        """K-class indices for multiclass specs, 0/1 otherwise."""
        if self.label_kind == "multiclass":
            return self.class_labels(frame)
        return self.binary_labels(frame)

    @property
    def n_classes(self) -> int:
        return len(self.classes) if self.classes else 2

    @property
    def feature_columns(self) -> tuple[str, ...]:
        return tuple(c for _, c, _ in self.template)


CICIDS2017 = DatasetSpec(
    name="cicids2017",
    template=CICIDS_TEMPLATE,
    label_column="Label",
    label_kind="positive",
    positive_value="DDoS",
)

CICDDOS2019 = DatasetSpec(
    name="cicddos2019",
    template=CICIDS_TEMPLATE,  # the same CICFlowMeter feature schema
    label_column="Label",
    label_kind="not_benign",
    benign_value="BENIGN",
)

UNSWNB15 = DatasetSpec(
    name="unswnb15",
    template=UNSW_TEMPLATE,
    label_column="label",
    label_kind="int",
)

#: The multi-class CIC-DDoS2019 preset: class 0 is BENIGN, the attack
#: order is data/synthetic.py's DDOS2019_ATTACKS.
CICDDOS2019_MC = DatasetSpec(
    name="cicddos2019-mc",
    template=CICIDS_TEMPLATE,
    label_column="Label",
    label_kind="multiclass",
    benign_value="BENIGN",
    classes=(
        "BENIGN",
        "DrDoS_DNS",
        "DrDoS_LDAP",
        "DrDoS_NTP",
        "DrDoS_UDP",
        "Syn",
        "UDP-lag",
    ),
)

DATASETS: dict[str, DatasetSpec] = {
    s.name: s for s in (CICIDS2017, CICDDOS2019, UNSWNB15, CICDDOS2019_MC)
}


def get_dataset(name: str) -> DatasetSpec:
    try:
        return DATASETS[name]
    except KeyError:
        raise ValueError(
            f"unknown dataset {name!r}; registered: {sorted(DATASETS)}"
        ) from None


#: Label values that occur only in CIC-DDoS2019 exports (beyond the
#: DrDoS_* prefix family, matched by prefix).
_DDOS2019_ONLY_LABELS = frozenset(
    {"Syn", "TFTP", "MSSQL", "NetBIOS", "LDAP", "Portmap", "UDP", "UDPLag",
     "UDP-lag", "WebDDoS"}
)


def detect_dataset(frame: Frame) -> DatasetSpec:
    """Schema sniffing for ``--source PATH`` entries without a name.

    UNSW-NB15 is told by its columns; CICIDS2017 and CIC-DDoS2019 share
    the CICFlowMeter schema and are told apart by their label vocabulary
    (CIC-DDoS2019 names specific DDoS attacks). Everything else, real
    CICIDS2017 exports with PortScan/Bot/DoS Hulk labels included, keeps
    the reference's semantics: only ``'DDoS'`` maps to 1."""
    cols = set(frame)
    if {"dur", "spkts", "dpkts"} <= cols:
        return UNSWNB15
    if "Label" in cols:
        values = set(map(str, np.asarray(frame["Label"]).tolist()))
        if any(v.startswith("DrDoS") for v in values) or (
            values & _DDOS2019_ONLY_LABELS
        ):
            return CICDDOS2019
        return CICIDS2017
    raise ValueError(
        "cannot detect dataset: no UNSW-NB15 columns and no 'Label' column "
        f"(have {sorted(cols)[:10]}...)"
    )


# ------------------------------------------------------------------ corpus
@dataclass
class Corpus:
    """Schema-erased training corpus: texts, labels and provenance."""

    texts: list[str]
    labels: np.ndarray  # [N] int32
    source: np.ndarray  # [N] int32 — index into source_names
    source_names: tuple[str, ...] = ()

    def __len__(self) -> int:
        return len(self.texts)

    def __post_init__(self) -> None:
        if not (len(self.texts) == len(self.labels) == len(self.source)):
            raise ValueError(
                f"corpus length mismatch: {len(self.texts)} texts, "
                f"{len(self.labels)} labels, {len(self.source)} source ids"
            )


def corpus_from_frame(frame: Frame, spec: DatasetSpec, source_id: int = 0) -> Corpus:
    texts = spec.render_texts(frame)
    return Corpus(
        texts=texts,
        labels=spec.labels(frame),
        source=np.full(len(texts), source_id, np.int32),
        source_names=(spec.name,),
    )


def concat_corpora(parts: Sequence[Corpus]) -> Corpus:
    """One mixed corpus; each part's source ids re-based onto the
    combined ``source_names``."""
    texts: list[str] = []
    labels: list[np.ndarray] = []
    source: list[np.ndarray] = []
    names: list[str] = []
    for part in parts:
        base = len(names)
        names.extend(part.source_names)
        texts.extend(part.texts)
        labels.append(part.labels)
        source.append(part.source + base)
    return Corpus(
        texts,
        np.concatenate(labels) if labels else np.zeros(0, np.int32),
        np.concatenate(source) if source else np.zeros(0, np.int32),
        tuple(names),
    )


def load_mixed_corpus(entries: Sequence[tuple[str | None, str]]) -> Corpus:
    """``(dataset name or None, csv path)`` entries -> one corpus; a None
    name is sniffed with :func:`detect_dataset`. Each file is imputed on
    its own, as :func:`.cicids.load_flow_csv` does."""
    from .cicids import load_flow_csv

    parts = []
    for name, path in entries:
        frame = load_flow_csv(path)
        spec = get_dataset(name) if name else detect_dataset(frame)
        parts.append(corpus_from_frame(frame, spec))
    return concat_corpora(parts)


def parse_source_arg(arg: str) -> tuple[str | None, str]:
    """The CLI's ``--source [DATASET=]PATH``."""
    if "=" in arg:
        name, path = arg.split("=", 1)
        get_dataset(name)  # validate early
        return name, path
    return None, arg
