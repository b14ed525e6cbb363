"""fedtpu on PyTorch and CUDA: the port of the JAX package to one H100.

This package stands beside the JAX package and imports nothing of it (nor
JAX itself). Its first slice is the scoring service, ``infer-serve``:
flow record -> template text -> WordPiece ids -> micro-batcher -> padded
bucket -> DistilBERT forward (with the hand-written flash-attention
kernel, ``ops/flash_attention.py`` + ``csrc/flash_fwd.cu``) -> softmax ->
reply frame, byte-compatible with the JAX package's scoring clients.

Run it with ``python -m <this package> infer-serve --registry-dir DIR``.
"""

__version__ = "0.1.0"

from .config import ModelConfig  # noqa: F401
from .device import resolve_device  # noqa: F401
