import sys

from tpu_gpad_torch.cli import main

sys.exit(main())
