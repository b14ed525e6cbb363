from .textualize import (  # noqa: F401
    CICIDS_TEMPLATE,
    FLOW_TEXT_COLUMNS,
    flow_to_text,
    render_row,
    render_template,
)
from .tokenizer import (  # noqa: F401
    WordPieceTokenizer,
    build_domain_vocab,
    build_reference_scale_vocab,
    default_tokenizer,
)
