"""python -m avrecode_tpu_torch: the command line (cli.py)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
