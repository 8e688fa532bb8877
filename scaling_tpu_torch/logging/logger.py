"""Console, per-rank log file, per-step metrics JSONL, the events file and
TensorBoard (counterpart of scaling_tpu/logging/logger.py).

``logger`` is the process's logger, as in the JAX package;
``logger.configure(config)`` wires its sinks. It sends the
``scaling_tpu_torch`` log to the console and, with ``log_dir``, to
``<log_dir>/rank_0.log``. ``log_metrics`` prints one line a step, appends
the JAX trainer's record to the metrics JSONL (``metrics_path``, else
``<log_dir>/metrics_rank_0.jsonl``):
``{"kind": "step", "step", "ts", "host", "metrics": {name: value}}``,
non-finite values as null, and with ``use_tensorboard`` writes each
numeric metric as a scalar under ``<log_dir>/tensorboard``
(``torch.utils.tensorboard``). ``log_event`` appends one JSON line a
lifecycle event to the events file (``SCALING_TPU_EVENTS_PATH``, else
``events_path``) and mirrors it to the log. wandb is not installed and
stays refused by name.

A worker of several ranks sets its rank (``set_rank``): its console lines
and ``rank_{r}.log`` carry it, and only global rank 0 writes step records
and events (``metrics_ranks`` and ``tensorboard_ranks`` choose others),
as the JAX controller alone writes them.
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

# obs.spans registers a provider at import so that every log_event record
# emitted under an active trace context carries the trace id. The hook is
# a module-level callback, not an import: logging sits below obs.
_trace_provider = None


def set_trace_provider(provider) -> None:
    """Register a zero-argument callable returning extra fields (or None)
    to merge into every ``log_event`` record. Explicit fields win; a
    provider that raises adds nothing (telemetry is best-effort)."""
    global _trace_provider
    _trace_provider = provider


@dataclasses.dataclass(frozen=True)
class LoggerConfig:
    """The ``logger`` section, under the JAX key names and defaults."""

    log_level: str = "info"
    log_dir: Optional[str] = None
    # JSONL of lifecycle events; SCALING_TPU_EVENTS_PATH overrides it
    events_path: Optional[str] = None
    metrics_path: Optional[str] = None
    metrics_jsonl: bool = True
    metrics_ranks: Optional[List[int]] = None  # None: rank 0, the port's only rank
    use_wandb: bool = False  # not ported
    use_tensorboard: bool = False
    tensorboard_ranks: Optional[List[int]] = None  # None: rank 0
    # settings of wandb, inert while it is off; determined_metrics_ranks is
    # config parity in the JAX package too
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
        if self.use_wandb:
            raise NotImplementedError("logger.use_wandb is not ported (wandb is not installed)")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LoggerConfig":
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown logger keys: {sorted(unknown)}")
        return cls(**d)


class _Stdout(logging.StreamHandler):
    """A console handler writing to the ``sys.stdout`` of the moment, so a
    process-wide logger follows a redirected stdout."""

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, value):
        pass


def _rank_enabled(ranks: Optional[List[int]], rank: int = 0) -> bool:
    return rank == 0 if ranks is None else rank in ranks


class Logger:
    """A run's logger; ``configure`` wires its sinks. The module's
    ``logger`` is the one the trainer, the engine and ``obs`` share."""

    def __init__(self, config: Optional[LoggerConfig] = None, name: str = ""):
        self._log = logging.getLogger(LOGGER_NAME)
        self._log.propagate = False
        self._tb_writer: Any = None
        self.rank = 0
        self.configure(config or LoggerConfig(), name)

    def set_rank(self, rank: int) -> None:
        """This process's global rank; the sinks are wired again for it."""
        self.rank = rank
        self.configure(self.config, self._name)

    def configure(self, config: LoggerConfig, name: str = "") -> None:
        self.config = config
        self._name = name
        self._log.setLevel(_LEVELS[config.log_level])
        for h in list(self._log.handlers):
            self._log.removeHandler(h)
            h.close()
        prefix = f"[rank {self.rank}]" + (f" [{name}]" if name else "")
        fmt = logging.Formatter(f"[%(asctime)s] {prefix} [%(levelname)s] %(message)s")
        handlers: List[logging.Handler] = [_Stdout()]
        if config.metrics_path:  # the registry's flushes fall back to it
            Path(config.metrics_path).parent.mkdir(parents=True, exist_ok=True)
        if config.log_dir:
            Path(config.log_dir).mkdir(parents=True, exist_ok=True)
            handlers.append(logging.FileHandler(Path(config.log_dir) / f"rank_{self.rank}.log"))
        for h in handlers:
            h.setFormatter(fmt)
            self._log.addHandler(h)
        if self._tb_writer is not None:
            self._tb_writer.close()
            self._tb_writer = None
        if config.use_tensorboard and _rank_enabled(config.tensorboard_ranks, self.rank):
            from torch.utils.tensorboard import SummaryWriter

            self._tb_writer = SummaryWriter(
                log_dir=str(Path(config.log_dir or ".") / "tensorboard"))

    def debug(self, msg: Any) -> None:
        self._log.debug(msg)

    def info(self, msg: Any) -> None:
        self._log.info(msg)

    def warning(self, msg: Any) -> None:
        self._log.warning(msg)

    def error(self, msg: Any) -> None:
        self._log.error(msg)

    def critical(self, msg: Any) -> None:
        self._log.critical(msg)

    # -------------------------------------------------------------- events
    def events_path(self) -> Optional[str]:
        """The events file: the environment's first (a launcher redirecting
        a child process wins over its config), then the config's."""
        return os.environ.get("SCALING_TPU_EVENTS_PATH") or self.config.events_path

    def log_event(self, event: str, _level: str = "info", _fsync: bool = True,
                  **fields: Any) -> None:
        """A lifecycle event: one JSON line appended to the events file,
        fsync'd unless ``_fsync=False`` (per-step spans pass False), and
        mirrored to the log at ``_level``. Without an events file only the
        mirror line is written, and with the mirror's level off as well the
        record is not even built (spans run on every tick and step)."""
        path = self.events_path() if self.rank == 0 else None
        if not path and not self._log.isEnabledFor(_LEVELS.get(_level, logging.INFO)):
            return
        record = {"event": event, "ts": time.time(), **fields}
        if _trace_provider is not None:
            try:
                extra = _trace_provider()
            except Exception:
                extra = None
            for k, v in (extra or {}).items():
                record.setdefault(k, v)
        line = json.dumps(record, sort_keys=True, default=str)
        getattr(self, _level, self.info)(f"EVENT {line}")
        if path:
            try:
                with open(path, "a") as f:
                    f.write(line + "\n")
                    f.flush()
                    if _fsync:
                        os.fsync(f.fileno())
            except OSError as e:
                self.warning(f"could not append event to {path}: {e!r}")

    # ------------------------------------------------------------- metrics
    def metrics_path(self) -> Optional[Path]:
        """Where step records go, or None when the sink is off: the
        ``SCALING_TPU_METRICS_PATH`` environment variable, then
        ``metrics_path``, then ``<log_dir>/metrics_rank_0.jsonl``."""
        c = self.config
        if not _rank_enabled(c.metrics_ranks, self.rank):
            return None
        env = os.environ.get("SCALING_TPU_METRICS_PATH")
        if env:
            return Path(env)
        if not c.metrics_jsonl:
            return None
        if c.metrics_path:
            return Path(c.metrics_path)
        if c.log_dir:
            return Path(c.log_dir) / f"metrics_rank_{self.rank}.jsonl"
        return None

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        if not _rank_enabled(self.config.metrics_ranks, self.rank):
            return
        numeric = {k: float(v) for k, v in metrics.items() if v is not None}
        self.info(f"step {step} | " + " | ".join(f"{k}: {v:.6g}" for k, v in numeric.items()))
        path = self.metrics_path()
        if path is not None:
            record = {"kind": "step", "step": step, "ts": time.time(), "host": _host_id(self.rank),
                      "metrics": {k: (v if math.isfinite(v) else None)
                                  for k, v in numeric.items()}}
            try:
                path.parent.mkdir(parents=True, exist_ok=True)
                append_jsonl_line(path, json.dumps(record, sort_keys=True))
            except OSError as e:
                self.warning(f"could not append metrics to {path}: {e!r}")
        if self._tb_writer is not None:
            for k, v in numeric.items():
                self._tb_writer.add_scalar(k, v, step)


def append_jsonl_line(path: Any, line: str) -> None:
    """Append one line in a single ``write(2)`` on an O_APPEND descriptor,
    so records of several threads or processes sharing a file never
    interleave (a buffered file object splits writes above its 8 KiB
    buffer)."""
    fd = os.open(str(path), os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    try:
        os.write(fd, (line + "\n").encode())
    finally:
        os.close(fd)


def _host_id(rank: int = 0) -> int:
    """The host id of metric records: ``SCALING_TPU_HOST_ID`` when a
    supervisor set it, else the rank."""
    try:
        return int(os.environ.get("SCALING_TPU_HOST_ID", rank))
    except ValueError:
        return rank


logger = Logger()
