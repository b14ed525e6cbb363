"""``python -m <package>.cli``: the same entry point as ``python -m <package>``."""

import sys

from .parser import main

if __name__ == "__main__":
    sys.exit(main())
