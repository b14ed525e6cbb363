from .convert import flatten_tree, params_from_jax, params_to_jax  # noqa: F401
from .distilbert import (  # noqa: F401
    DDoSClassifier,
    DistilBertEncoder,
    build_model,
    init_params,
)
from .presets import PRESETS, model_preset, preset_names  # noqa: F401
