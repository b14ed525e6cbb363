"""WordPiece tokenizer (BERT-compatible), pure Python + numpy.

The port's copy of the JAX package's ``data/tokenizer.py``: BasicTokenizer
(clean, lowercase, accent-strip, punctuation split) + greedy longest-match
WordPiece with ``##`` continuations, and the same vocab functions, so both
packages turn a flow sentence into the same ids. ``batch_encode`` sends
pure-ASCII batches to the native C++ encoder built from the repository's
``native/wordpiece.cpp`` (``data/native_tokenizer.py``) when the vocab
allows it, and every other batch through the Python path here; both give
the same ids.

Because there is no pretrained vocab offline, the default vocab is
*domain-complete*: every sentence the flow template can emit tokenizes
with zero ``[UNK]``s.
"""

from __future__ import annotations

import string
import threading
import unicodedata
from collections import Counter
from typing import Iterable, Mapping, Sequence

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIAL_TOKENS = (PAD, UNK, CLS, SEP, MASK)

#: Whole words appearing in the flow-text template (textualize.py), lowercased.
TEMPLATE_WORDS: tuple[str, ...] = (
    "destination", "port", "is", "flow", "duration", "microseconds",
    "total", "forward", "packets", "are", "backward", "length", "of",
    "bytes", "maximum", "packet", "minimum", "per", "second", "nan", "inf",
)

#: UNSW-NB15 template words (datasets.py UNSW_TEMPLATE) plus the categorical
#: values its proto/service columns commonly take. Appended AFTER the
#: char/punct block in build_domain_vocab so every pre-existing token keeps
#: its id (already-tokenized data stays valid). The vocab still GROWS, so a
#: model checkpoint pinned to the old vocab_size has a smaller embedding
#: table — maybe_warm_start degrades to a fresh start on that mismatch.
EXTRA_TEMPLATE_WORDS: tuple[str, ...] = (
    "protocol", "service", "seconds", "source", "to", "rate", "load", "bits",
    "tcp", "udp", "arp", "icmp", "http", "dns", "smtp", "ftp", "ssh", "normal",
)


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def basic_tokenize(text: str, lowercase: bool = True) -> list[str]:
    """BERT BasicTokenizer: clean, whitespace-split, lowercase + accent-strip,
    split punctuation into standalone tokens."""
    cleaned = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        cleaned.append(" " if _is_whitespace(ch) else ch)
    out: list[str] = []
    for word in "".join(cleaned).split():
        if lowercase:
            word = word.lower()
            word = "".join(
                c for c in unicodedata.normalize("NFD", word)
                if unicodedata.category(c) != "Mn"
            )
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


def build_domain_vocab(
    corpus: Iterable[str] | None = None,
    max_corpus_words: int = 10000,
    min_freq: int = 1,
) -> list[str]:
    """Vocab that fully covers the flow-text domain; optionally extended with
    frequent whole words from a corpus (most-frequent first, deterministic)."""
    vocab: list[str] = list(SPECIAL_TOKENS)
    seen = set(vocab)

    def _add(tok: str) -> None:
        if tok and tok not in seen:
            vocab.append(tok)
            seen.add(tok)

    for w in TEMPLATE_WORDS:
        _add(w)
    base_chars = string.ascii_lowercase + string.digits
    for c in base_chars:
        _add(c)
        _add("##" + c)
    for c in string.punctuation:
        _add(c)
    # New whole-word entries go after the stable id range (see
    # EXTRA_TEMPLATE_WORDS): ids 0..129 are frozen for back-compat.
    for w in EXTRA_TEMPLATE_WORDS:
        _add(w)
    if corpus is not None:
        counts: Counter[str] = Counter()
        for text in corpus:
            for tok in basic_tokenize(text):
                counts[tok] += 1
        for tok, freq in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
            if freq < min_freq or len(seen) - len(SPECIAL_TOKENS) >= max_corpus_words:
                break
            _add(tok)
    return vocab


def build_reference_scale_vocab(size: int = 30522) -> list[str]:
    """A deterministic vocab at the reference's REAL scale — 30522 entries,
    the vocab_size of its required ``./distilbert-base-uncased``
    (client1.py:56,357 via HF) — for end-to-end exercises of the full
    embedding table and WordPiece path without network access.

    Layout: the domain vocab first (template words, chars, ##-pieces —
    flow texts tokenize with zero [UNK]s), then whole-number tokens
    0..9999 and their ##-continuations (realistic multi-piece numerals),
    then ``[unusedN]`` filler up to exactly ``size``."""
    vocab = build_domain_vocab()
    seen = set(vocab)

    def _add(tok: str) -> None:
        if tok not in seen and len(vocab) < size:
            vocab.append(tok)
            seen.add(tok)

    for n in range(10_000):
        _add(str(n))
    for n in range(10_000):
        _add(f"##{n}")
    i = 0
    while len(vocab) < size:
        _add(f"[unused{i}]")
        i += 1
    if len(vocab) != size:
        raise ValueError(f"vocab overflow: base entries exceed size={size}")
    return vocab


class WordPieceTokenizer:
    """Greedy longest-match WordPiece over a BasicTokenizer pre-split."""

    def __init__(
        self,
        vocab: Sequence[str] | Mapping[str, int],
        lowercase: bool = True,
        max_input_chars_per_word: int = 100,
    ):
        if isinstance(vocab, Mapping):
            self.vocab: dict[str, int] = dict(vocab)
        else:
            self.vocab = {tok: i for i, tok in enumerate(vocab)}
        if len(self.vocab) < len(SPECIAL_TOKENS):
            raise ValueError("vocab too small")
        for tok in SPECIAL_TOKENS:
            if tok not in self.vocab:
                raise ValueError(f"vocab missing special token {tok}")
        self.lowercase = lowercase
        self.max_input_chars_per_word = max_input_chars_per_word
        self.pad_id = self.vocab[PAD]
        self.unk_id = self.vocab[UNK]
        self.cls_id = self.vocab[CLS]
        self.sep_id = self.vocab[SEP]
        self._word_cache: dict[str, list[int]] = {}
        self._native = None  # bound lazily by the first batch_encode
        self._native_tried = False
        self._native_lock = threading.Lock()
        self._last_native = False

    def __len__(self) -> int:
        return len(self.vocab)

    def _wordpiece(self, word: str) -> list[int]:
        # Flow text is dominated by unique numeric strings — caching those
        # would grow without bound at near-zero hit rate. Cache only
        # alphabetic words (template vocabulary), which repeat constantly;
        # the size cap bounds insertions only — lookups always hit.
        cacheable = word.isalpha()
        cached = self._word_cache.get(word) if cacheable else None
        if cached is not None:
            return cached
        if len(word) > self.max_input_chars_per_word:
            ids = [self.unk_id]
        else:
            ids = []
            start = 0
            n = len(word)
            while start < n:
                end = n
                piece_id = None
                while start < end:
                    sub = word[start:end]
                    if start > 0:
                        sub = "##" + sub
                    pid = self.vocab.get(sub)
                    if pid is not None:
                        piece_id = pid
                        break
                    end -= 1
                if piece_id is None:
                    ids = [self.unk_id]
                    break
                ids.append(piece_id)
                start = end
        if cacheable and len(self._word_cache) < 65536:
            self._word_cache[word] = ids
        return ids

    def encode(self, text: str, max_len: int | None = None) -> list[int]:
        """``[CLS] pieces... [SEP]`` truncated to ``max_len`` (specials kept),
        matching HF ``add_special_tokens=True, truncation=True``."""
        ids = [
            i for w in basic_tokenize(text, self.lowercase) for i in self._wordpiece(w)
        ]
        if max_len is not None:
            ids = ids[: max_len - 2]
        return [self.cls_id, *ids, self.sep_id]

    def _native_encoder(self):
        """This vocab bound into the native batch encoder, or None: only a
        dense (ids 0..n-1), newline-free vocab with no empty token and the
        default word-length cap takes it, else the Python path is the
        authority (the JAX package's conditions)."""
        with self._native_lock:
            if self._native_tried:
                return self._native
            self._native_tried = True
            if self.max_input_chars_per_word != 100:
                return None
            tokens: list[str | None] = [None] * len(self.vocab)
            for tok, i in self.vocab.items():
                # An empty token would vanish from the '\n'-joined vocab
                # blob and shift every later id.
                if not tok or "\n" in tok or not 0 <= i < len(tokens) or tokens[i] is not None:
                    return None
                tokens[i] = tok
            if any(t is None for t in tokens):
                return None
            from .native_tokenizer import NativeWordPiece

            self._native = NativeWordPiece.create(tokens)
            return self._native

    @property
    def native_active(self) -> bool:
        """Whether the last ``batch_encode`` ran on the native encoder."""
        return self._last_native

    def batch_encode(
        self, texts: Sequence[str], max_len: int = 128
    ) -> dict[str, np.ndarray]:
        """Static-shape ``[N, max_len]`` int32 ``input_ids`` + ``attention_mask``
        (equivalent to HF ``padding='max_length'``). Pure-ASCII batches
        take the native encoder when it is available; anything else runs
        :meth:`batch_encode_python`, with the same ids."""
        native = self._native_encoder()
        if native is not None:
            out = native.encode_batch(texts, max_len, lowercase=self.lowercase)
            if out is not None:
                self._last_native = True
                return out
        self._last_native = False
        return self.batch_encode_python(texts, max_len)

    def batch_encode_python(
        self, texts: Sequence[str], max_len: int = 128
    ) -> dict[str, np.ndarray]:
        """:meth:`batch_encode` on the Python path alone."""
        n = len(texts)
        input_ids = np.full((n, max_len), self.pad_id, dtype=np.int32)
        attention_mask = np.zeros((n, max_len), dtype=np.int32)
        for r, text in enumerate(texts):
            ids = self.encode(text, max_len)
            input_ids[r, : len(ids)] = ids
            attention_mask[r, : len(ids)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}


def default_tokenizer() -> WordPieceTokenizer:
    return WordPieceTokenizer(build_domain_vocab())
