"""fedtpu on PyTorch and CUDA: the port of the JAX package to one H100.

This package stands beside the JAX package and imports nothing of it (nor
JAX itself). Its slices so far:

* ``infer-serve``, the scoring service: flow record -> template text ->
  WordPiece ids -> micro-batcher -> padded bucket -> DistilBERT forward ->
  softmax -> reply frame, byte-compatible with the JAX package's clients;
* ``local``, single-client training: flows -> per-client splits -> token
  arrays -> DistilBERT fine-tuning with dropout and a hand-written Adam ->
  evaluation -> the reference's metrics CSV.

Attention runs in hand-written CUDA kernels on the card
(``ops/flash_attention.py``: ``csrc/flash_fwd.cu`` forward,
``csrc/flash_bwd.cu`` backward, ``csrc/keep_mask.cuh`` dropout).

Run them with ``python -m <this package> local --synthetic 2400`` and
``python -m <this package> infer-serve --registry-dir DIR``.
"""

__version__ = "0.1.0"

from .config import ModelConfig  # noqa: F401
from .device import resolve_device  # noqa: F401
