import sys

from dprf_tpu_torch.cli import main

sys.exit(main())
