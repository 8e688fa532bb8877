"""``python -m scaling_tpu_torch.serve bench [flags]`` runs the serving
benchmark (serve/bench.py)."""

import sys


def _main(argv) -> int:
    if not argv or argv[0] != "bench":
        print("usage: python -m scaling_tpu_torch.serve bench [--help]", file=sys.stderr)
        return 2
    from .bench import main

    return main(argv[1:])


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
