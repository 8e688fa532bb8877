"""``python -m scaling_tpu_torch.train bench [flags]``: the training benchmark."""

import sys

from .bench import main

if __name__ == "__main__":
    argv = sys.argv[1:]
    if not argv or argv[0] != "bench":
        sys.exit("usage: python -m scaling_tpu_torch.train bench [--help]")
    sys.exit(main(argv[1:]))
