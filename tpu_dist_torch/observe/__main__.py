import sys

from tpu_dist_torch.observe.cli import main

sys.exit(main())
