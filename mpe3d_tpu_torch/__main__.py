"""``python -m mpe3d_tpu_torch {serve,infer} ...`` (``cli.py``)."""

import sys

from mpe3d_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
