import sys

from cudacam_tpu_torch.cli import main

sys.exit(main())
