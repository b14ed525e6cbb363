"""Named model-size presets — the registry behind ``--preset``.

A copy of the JAX package's ``models/presets.py`` over the port's
``ModelConfig``, so both packages resolve a preset name to the same
architecture.
"""

from __future__ import annotations

from typing import Any, Callable

from ..config import ModelConfig

#: name -> ModelConfig factory, ordered small -> large.
PRESETS: dict[str, Callable[..., ModelConfig]] = {
    "tiny": ModelConfig.tiny,
    "distilbert": ModelConfig.distilbert_base,
    "bert": ModelConfig.bert_base,
    "bert-large": ModelConfig.bert_large,
}


def preset_names() -> tuple[str, ...]:
    """The registry's names in ladder order (for help/error strings)."""
    return tuple(PRESETS)


def model_preset(name: str, **kw: Any) -> ModelConfig:
    """Resolve a preset name to its ModelConfig (ValueError on unknown)."""
    try:
        factory = PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown model preset {name!r} (one of: {'|'.join(PRESETS)})"
        ) from None
    return factory(**kw)
