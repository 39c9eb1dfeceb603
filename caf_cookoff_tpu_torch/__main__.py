"""``python -m caf_cookoff_tpu_torch`` entry point."""

import sys

from caf_cookoff_tpu_torch.cli import main

sys.exit(main())
