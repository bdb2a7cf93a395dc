import sys

from tpu_dist_torch.jobs.cli import main

sys.exit(main())
