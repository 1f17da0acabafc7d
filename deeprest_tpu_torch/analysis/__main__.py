"""``python -m deeprest_tpu_torch.analysis``: an alias of ``python -m
deeprest_tpu_torch lint``."""

import sys

from deeprest_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main(["lint", *sys.argv[1:]]))
