"""``python -m scaling_tpu_torch.train bench [flags]``: the training benchmark;
``python -m scaling_tpu_torch.train run <config.yml> [--device cpu]``: train
as a JAX training config says (``models/transformer/train.py:main``), on
the card unless ``--device cpu`` is given."""

import argparse
import sys
from pathlib import Path

USAGE = "usage: python -m scaling_tpu_torch.train {bench,run} [--help]"


def run(argv) -> int:
    import yaml

    from ..models.transformer import TransformerConfig
    from ..models.transformer.train import main

    p = argparse.ArgumentParser(prog="python -m scaling_tpu_torch.train run")
    p.add_argument("config", type=Path, help="a JAX training config (YAML)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    args = p.parse_args(argv)
    config = TransformerConfig.from_dict(yaml.safe_load(args.config.read_text()))
    trainer = main(config, device=args.device)
    print(f"train run: device={trainer.device} iterations={trainer.context.iterations} "
          f"consumed_samples={trainer.context.consumed_samples}")
    return 0


if __name__ == "__main__":
    argv = sys.argv[1:]
    if argv[:1] == ["bench"]:
        from .bench import main as bench

        sys.exit(bench(argv[1:]))
    if argv[:1] == ["run"]:
        sys.exit(run(argv[1:]))
    sys.exit(USAGE)
