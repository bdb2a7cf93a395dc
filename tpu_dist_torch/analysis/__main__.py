"""``python -m tpu_dist_torch.analysis`` entry point."""

import sys

from tpu_dist_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
