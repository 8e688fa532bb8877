"""Per-run state: iteration counters and the seed (counterpart of
scaling_tpu/context/context.py).

``context.json`` holds ``iterations``, ``consumed_samples``,
``consumed_eval_samples`` and ``seed``, written and read as the JAX
package writes and reads it, so either package resumes the other's
counters.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional, Union

from ..topology import TopologyConfig


class BaseContext:
    def __init__(self, config: Any, topology: TopologyConfig):
        self.config = config
        self.topology = topology
        self.iterations = 0
        self.consumed_samples = 0
        self.consumed_eval_samples = 0
        self.seed: Optional[int] = None

    def initialize(self, seed: int) -> None:
        self.seed = seed

    def step(self) -> None:
        self.iterations += 1
        self.consumed_samples += self.topology.global_batch_size

    def state_dict(self) -> dict:
        return {
            "iterations": self.iterations,
            "consumed_samples": self.consumed_samples,
            "consumed_eval_samples": self.consumed_eval_samples,
            "seed": self.seed,
        }

    def load_state_dict(self, state: dict) -> None:
        self.iterations = int(state["iterations"])
        self.consumed_samples = int(state["consumed_samples"])
        self.consumed_eval_samples = int(state.get("consumed_eval_samples", 0))
        if state.get("seed") is not None:
            self.initialize(int(state["seed"]))

    def save_checkpoint(self, dir: Union[Path, str]) -> None:
        path = Path(dir)
        path.mkdir(parents=True, exist_ok=True)
        (path / "context.json").write_text(json.dumps(self.state_dict(), indent=2))

    def load_checkpoint(self, dir: Union[Path, str]) -> bool:
        f = Path(dir) / "context.json"
        if not f.is_file():
            return False
        self.load_state_dict(json.loads(f.read_text()))
        return True
