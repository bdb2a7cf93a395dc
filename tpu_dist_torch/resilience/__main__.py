import sys

from tpu_dist_torch.resilience.cli import main

sys.exit(main())
