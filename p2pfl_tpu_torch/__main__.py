"""``python -m p2pfl_tpu_torch``: the port's command line (:mod:`p2pfl_tpu_torch.cli`)."""

import sys

from p2pfl_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
