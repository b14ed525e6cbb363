from .parser import build_parser, main  # noqa: F401
