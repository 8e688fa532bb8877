"""Console, per-rank log file and per-step metrics JSONL (counterpart of
scaling_tpu/logging/logger.py on one device, rank 0).

``Logger(config)`` sends the ``scaling_tpu_torch`` log to the console
and, with ``log_dir``, to ``<log_dir>/rank_0.log``. ``log_metrics`` prints
one line a step and appends the JAX trainer's record to the metrics JSONL
(``metrics_path``, else ``<log_dir>/metrics_rank_0.jsonl``):
``{"kind": "step", "step", "ts", "host", "metrics": {name: value}}``,
non-finite values as null. TensorBoard, wandb and the lifecycle events
file are not ported: turning one on raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO, "warning": logging.WARNING,
           "error": logging.ERROR, "critical": logging.CRITICAL}
LOGGER_NAME = "scaling_tpu_torch"


@dataclasses.dataclass(frozen=True)
class LoggerConfig:
    """The ``logger`` section, under the JAX key names and defaults."""

    log_level: str = "info"
    log_dir: Optional[str] = None
    events_path: Optional[str] = None  # not ported: must stay None
    metrics_path: Optional[str] = None
    metrics_jsonl: bool = True
    metrics_ranks: Optional[List[int]] = None  # None: rank 0, the port's only rank
    use_wandb: bool = False  # not ported
    use_tensorboard: bool = False  # not ported
    # the settings of the sinks above; inert while those are off, as in
    # the JAX package (determined_metrics_ranks is config parity there)
    tensorboard_ranks: Optional[List[int]] = None
    determined_metrics_ranks: Optional[List[int]] = None
    wandb_ranks: Optional[List[int]] = None
    wandb_host: Optional[str] = None
    wandb_team: Optional[str] = None
    wandb_project: str = "scaling_tpu"
    wandb_group: str = "default"
    wandb_api_key: Optional[str] = None

    def __post_init__(self):
        if self.log_level not in _LEVELS:
            raise ValueError(f"logger.log_level must be one of {sorted(_LEVELS)}")
        for key in ("use_wandb", "use_tensorboard"):
            if getattr(self, key):
                raise NotImplementedError(f"logger.{key} is not ported")
        if self.events_path is not None:
            raise NotImplementedError("logger.events_path (lifecycle events) is not ported")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LoggerConfig":
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown logger keys: {sorted(unknown)}")
        return cls(**d)


class Logger:
    """The run's logger; ``configure`` wires its sinks."""

    def __init__(self, config: Optional[LoggerConfig] = None, name: str = ""):
        self._log = logging.getLogger(LOGGER_NAME)
        self._log.propagate = False
        self.configure(config or LoggerConfig(), name)

    def configure(self, config: LoggerConfig, name: str = "") -> None:
        self.config = config
        self._log.setLevel(_LEVELS[config.log_level])
        for h in list(self._log.handlers):
            self._log.removeHandler(h)
            h.close()
        prefix = "[rank 0]" + (f" [{name}]" if name else "")
        fmt = logging.Formatter(f"[%(asctime)s] {prefix} [%(levelname)s] %(message)s")
        handlers: List[logging.Handler] = [logging.StreamHandler(sys.stdout)]
        if config.log_dir:
            Path(config.log_dir).mkdir(parents=True, exist_ok=True)
            handlers.append(logging.FileHandler(Path(config.log_dir) / "rank_0.log"))
        for h in handlers:
            h.setFormatter(fmt)
            self._log.addHandler(h)

    def info(self, msg: Any) -> None:
        self._log.info(msg)

    def warning(self, msg: Any) -> None:
        self._log.warning(msg)

    def metrics_path(self) -> Optional[Path]:
        """Where step records go, or None when the sink is off."""
        c = self.config
        if not c.metrics_jsonl or (c.metrics_ranks is not None and 0 not in c.metrics_ranks):
            return None
        if c.metrics_path:
            return Path(c.metrics_path)
        if c.log_dir:
            return Path(c.log_dir) / "metrics_rank_0.jsonl"
        return None

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        if self.config.metrics_ranks is not None and 0 not in self.config.metrics_ranks:
            return
        numeric = {k: float(v) for k, v in metrics.items() if v is not None}
        self.info(f"step {step} | " + " | ".join(f"{k}: {v:.6g}" for k, v in numeric.items()))
        path = self.metrics_path()
        if path is None:
            return
        record = {"kind": "step", "step": step, "ts": time.time(), "host": 0,
                  "metrics": {k: (v if math.isfinite(v) else None) for k, v in numeric.items()}}
        path.parent.mkdir(parents=True, exist_ok=True)
        fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:  # one write(2) a record
            os.write(fd, (json.dumps(record, sort_keys=True) + "\n").encode())
        finally:
            os.close(fd)
