"""Flow traffic from a seed: rows, flow sentences, WordPiece ids.

A frozen copy of the port's data path, so that later changes to the
program cannot move the benchmark's inputs:

* ``make_synthetic_flows``: the port's ``data/synthetic.py`` generator
  (CICIDS2017-like BENIGN/DDoS rows with ±inf and NaN in the float
  columns), draw for draw;
* ``impute``: ``data/cicids.py``'s load-time imputation (±inf -> NaN ->
  the column's mean over its finite values);
* ``render``: ``data/textualize.py``'s CICIDS2017 sentence template;
* ``reference_scale_vocab`` and ``WordPiece``: ``data/tokenizer.py``'s
  30522-entry vocabulary and its BasicTokenizer + greedy WordPiece.

``WordPiece.encode_batch`` takes a regular-expression path for printable
ASCII text that gives the ids of the character-by-character path
(``portbench/tests/test_flows.py`` holds the two equal), about ten
times faster, so a run's set-up does not wait on tokenizing its pool.
"""

from __future__ import annotations

import re
import string
import unicodedata
from typing import Sequence

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIAL_TOKENS = (PAD, UNK, CLS, SEP, MASK)

TEMPLATE_WORDS = (
    "destination", "port", "is", "flow", "duration", "microseconds",
    "total", "forward", "packets", "are", "backward", "length", "of",
    "bytes", "maximum", "packet", "minimum", "per", "second", "nan", "inf",
)
EXTRA_TEMPLATE_WORDS = (
    "protocol", "service", "seconds", "source", "to", "rate", "load", "bits",
    "tcp", "udp", "arp", "icmp", "http", "dns", "smtp", "ftp", "ssh", "normal",
)

EXTRA_COLUMNS = (
    "Fwd Packet Length Mean", "Fwd Packet Length Std", "Bwd Packet Length Max",
    "Bwd Packet Length Min", "Flow IAT Mean", "Flow IAT Std",
)

CICIDS_TEMPLATE = (
    ("Destination port is ", "Destination Port", ". "),
    ("Flow duration is ", "Flow Duration", " microseconds. "),
    ("Total forward packets are ", "Total Fwd Packets", ". "),
    ("Total backward packets are ", "Total Backward Packets", ". "),
    ("Total length of forward packets is ", "Total Length of Fwd Packets", " bytes. "),
    ("Total length of backward packets is ", "Total Length of Bwd Packets", " bytes. "),
    ("Maximum forward packet length is ", "Fwd Packet Length Max", ". "),
    ("Minimum forward packet length is ", "Fwd Packet Length Min", ". "),
    ("Flow bytes per second is ", "Flow Bytes/s", ". "),
    ("Flow packets per second is ", "Flow Packets/s", "."),
)


def make_synthetic_flows(
    n_rows: int, ddos_fraction: float = 0.5, seed: int = 0,
    inf_fraction: float = 0.01, nan_fraction: float = 0.01,
) -> dict[str, np.ndarray]:
    """A separable BENIGN/DDoS flow table as ``{column: array}``, rows
    shuffled, with ±inf and NaN in the float columns."""
    rng = np.random.default_rng(seed)
    n_ddos = int(n_rows * ddos_fraction)
    n_benign = n_rows - n_ddos

    def mix(benign, ddos):
        return np.concatenate([benign(n_benign), ddos(n_ddos)])

    cols: dict[str, np.ndarray] = {}
    cols["Destination Port"] = mix(
        lambda n: rng.choice([53, 443, 8080, 22, 3389], size=n),
        lambda n: rng.choice([80, 443], size=n),
    ).astype(np.int64)
    ints = (
        ("Flow Duration", (1_000, 10_000_000), (1, 5_000)),
        ("Total Fwd Packets", (1, 30), (100, 2_000)),
        ("Total Backward Packets", (1, 30), (0, 3)),
        ("Total Length of Fwd Packets", (0, 5_000), (50_000, 500_000)),
        ("Total Length of Bwd Packets", (0, 5_000), (0, 200)),
        ("Fwd Packet Length Max", (0, 1_500), (1_000, 1_500)),
        ("Fwd Packet Length Min", (0, 100), (500, 1_000)),
    )
    for name, (b0, b1), (d0, d1) in ints:
        cols[name] = mix(
            lambda n, lo=b0, hi=b1: rng.integers(lo, hi, size=n),
            lambda n, lo=d0, hi=d1: rng.integers(lo, hi, size=n),
        ).astype(np.int64)
    for name, (b0, b1), (d0, d1) in (
        ("Flow Bytes/s", (10, 1e5), (1e6, 5e7)),
        ("Flow Packets/s", (0.1, 1e3), (1e4, 1e6)),
    ):
        cols[name] = np.round(mix(
            lambda n, lo=b0, hi=b1: rng.uniform(lo, hi, size=n),
            lambda n, lo=d0, hi=d1: rng.uniform(lo, hi, size=n),
        ), 4)
    for name in EXTRA_COLUMNS:
        cols[name] = np.round(rng.uniform(0, 1_000, size=n_rows), 4)
    labels = np.array(["BENIGN"] * n_benign + ["DDoS"] * n_ddos)
    for name in ("Flow Bytes/s", "Flow Packets/s", *EXTRA_COLUMNS):
        arr = cols[name].astype(np.float64)
        bad = rng.random(n_rows)
        arr[bad < inf_fraction] = np.inf
        arr[(bad >= inf_fraction) & (bad < inf_fraction + nan_fraction)] = np.nan
        cols[name] = arr
    cols["Label"] = labels
    perm = rng.permutation(n_rows)
    return {name: col[perm] for name, col in cols.items()}


def impute(frame: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """±inf -> NaN -> the column's mean over its finite values, in every
    float column (what the port does when it loads a flow CSV)."""
    out = {}
    for name, col in frame.items():
        if col.dtype == np.float64:
            col = col.copy()
            col[np.isinf(col)] = np.nan
            missing = np.isnan(col)
            if missing.any():
                count = int((~missing).sum())
                col[missing] = np.where(missing, 0.0, col).sum() / count if count else np.nan
        out[name] = col
    return out


def render(frame: dict[str, np.ndarray]) -> list[str]:
    """The CICIDS2017 flow sentence of every row."""
    cols = [[f"{p}{v}{s}" for v in frame[c].tolist()] for p, c, s in CICIDS_TEMPLATE]
    return ["".join(row) for row in zip(*cols)]


def domain_vocab() -> list[str]:
    vocab = list(SPECIAL_TOKENS)
    seen = set(vocab)
    extra = [*TEMPLATE_WORDS]
    for c in string.ascii_lowercase + string.digits:
        extra += [c, "##" + c]
    extra += [*string.punctuation, *EXTRA_TEMPLATE_WORDS]
    for tok in extra:
        if tok not in seen:
            vocab.append(tok)
            seen.add(tok)
    return vocab


def reference_scale_vocab(size: int = 30522) -> list[str]:
    """The domain vocabulary, whole numbers 0..9999 and their ``##``
    continuations, then ``[unusedN]`` up to ``size`` entries."""
    vocab = domain_vocab()
    seen = set(vocab)
    fill = [str(n) for n in range(10_000)] + [f"##{n}" for n in range(10_000)]
    for tok in fill:
        if tok not in seen and len(vocab) < size:
            vocab.append(tok)
            seen.add(tok)
    i = 0
    while len(vocab) < size:
        tok = f"[unused{i}]"
        if tok not in seen:
            vocab.append(tok)
            seen.add(tok)
        i += 1
    return vocab


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str) -> list[str]:
    """BERT's BasicTokenizer (lowercasing), character by character."""
    cleaned = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or (ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")):
            continue
        ws = ch in " \t\n\r" or unicodedata.category(ch) == "Zs"
        cleaned.append(" " if ws else ch)
    out: list[str] = []
    for word in "".join(cleaned).split():
        word = "".join(c for c in unicodedata.normalize("NFD", word.lower()) if unicodedata.category(c) != "Mn")
        cur: list[str] = []
        for ch in word:
            if _is_punctuation(ch):
                if cur:
                    out.append("".join(cur))
                    cur = []
                out.append(ch)
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur))
    return out


# Printable ASCII: words are runs of letters and digits, every other
# non-space character is punctuation on its own.
_ASCII_WORDS = re.compile(r"[a-z0-9]+|[^a-z0-9 ]")


class WordPiece:
    """Greedy longest-match WordPiece over a BasicTokenizer pre-split."""

    def __init__(self, vocab: Sequence[str], max_chars: int = 100):
        self.vocab = {tok: i for i, tok in enumerate(vocab)}
        self.max_chars = max_chars
        self.pad_id = self.vocab[PAD]
        self.unk_id = self.vocab[UNK]
        self.cls_id = self.vocab[CLS]
        self.sep_id = self.vocab[SEP]

    def pieces(self, word: str) -> list[int]:
        if len(word) > self.max_chars:
            return [self.unk_id]
        ids, start, n = [], 0, len(word)
        while start < n:
            end, piece = n, None
            while start < end:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                piece = self.vocab.get(sub)
                if piece is not None:
                    break
                end -= 1
            if piece is None:
                return [self.unk_id]
            ids.append(piece)
            start = end
        return ids

    def words(self, text: str) -> list[str]:
        if text.isascii() and text.isprintable():
            return _ASCII_WORDS.findall(text.lower())
        return basic_tokenize(text)

    def encode_batch(self, texts: Sequence[str], max_len: int) -> tuple[np.ndarray, np.ndarray]:
        """``[N, max_len]`` int32 ids (``[CLS] ... [SEP]``, truncated, PAD
        after) and the 0/1 attention mask."""
        ids = np.full((len(texts), max_len), self.pad_id, np.int32)
        mask = np.zeros((len(texts), max_len), np.int32)
        cache: dict[str, list[int]] = {}
        for r, text in enumerate(texts):
            row = [self.cls_id]
            for w in self.words(text):
                p = cache.get(w)
                if p is None:
                    p = cache[w] = self.pieces(w)
                row += p
            row = row[: max_len - 1] + [self.sep_id]
            ids[r, : len(row)] = row
            mask[r, : len(row)] = 1
        return ids, mask


def flow_pool(traffic: dict, cfg: dict, seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The traffic's ``rows`` synthetic flows from ``seed`` as (ids, mask,
    labels), labels 1 for DDoS and 0 for BENIGN, imputed as a flow CSV is
    on loading."""
    frame = impute(make_synthetic_flows(
        traffic["rows"], traffic["ddos_fraction"], seed, traffic["inf_fraction"], traffic["nan_fraction"]))
    ids, mask = WordPiece(reference_scale_vocab(cfg["vocab_size"])).encode_batch(render(frame), cfg["max_len"])
    return ids, mask, (frame["Label"] == "DDoS").astype(np.int32)
