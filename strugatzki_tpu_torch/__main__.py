"""``python -m strugatzki_tpu_torch`` — CLI entry point."""

import sys

from .cli import main

sys.exit(main())
