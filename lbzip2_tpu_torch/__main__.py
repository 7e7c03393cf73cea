"""``python -m lbzip2_tpu_torch``: the port's front end as ``lbzip2``."""

import sys

from lbzip2_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main(["lbzip2", *sys.argv[1:]]))
