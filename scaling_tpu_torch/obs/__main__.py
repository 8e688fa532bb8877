"""Entry point for ``python -m scaling_tpu_torch.obs``: stdlib only, the
analyzer initialises no device."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
