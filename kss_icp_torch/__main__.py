import sys

from kss_icp_torch.cli import main

sys.exit(main())
