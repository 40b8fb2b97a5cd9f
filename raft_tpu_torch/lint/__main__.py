import sys

from raft_tpu_torch.lint.cli import main

sys.exit(main())
