import sys

from tpu_dist_torch.serve.cli import main

sys.exit(main())
