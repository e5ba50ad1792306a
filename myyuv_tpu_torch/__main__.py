"""``python -m myyuv_tpu_torch`` entry point (reference: myyuv_cli)."""

import sys

from .cli import main

sys.exit(main())
