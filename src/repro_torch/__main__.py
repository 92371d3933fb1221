"""Entry point: ``python -m repro_torch {simulate,sweep,plan,serve-sim,...}``."""

import sys

from .api.cli import main

if __name__ == "__main__":
    sys.exit(main())
