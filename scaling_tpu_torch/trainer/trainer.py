"""The training loop and its checkpoints on one device (counterpart of
scaling_tpu/trainer/trainer.py).

``run_training`` drives: train step -> periodic save -> periodic eval ->
metric logging, for ``train_iterations`` steps. Checkpoints follow the
JAX package's layout: ``save_dir/global_step{N}/`` with the model and
optimizer npz files, ``context.json``, ``config.yml`` and ``MANIFEST.json``,
committed atomically, then ``latest``. ``load_checkpoint`` takes the
newest candidate that verifies (``latest`` first), skipping corrupt ones
unless ``strict_checkpoint_load``, and warns when the checkpoint's
``config.yml`` reads to another config than the run's, where the JAX
trainer warns that its config fingerprint changed. The manifest carries
no fingerprint: the JAX one is a digest of the JAX config's full dump,
every default included, which the port does not rebuild, and a digest
of anything else would make a JAX resume of a port checkpoint warn for
no reason.

Micro-batches are stacked ``(gas, mbs, s)`` on the host and moved to the
device in one copy per step (``batch_to_model_input``). The JAX
trainer's preemption handling, control plane, stall watchdog, non-finite
guard, prefetch thread, asynchronous writer and orbax backend are not
ported: their config fields raise NotImplementedError at any value but
the default.
"""

from __future__ import annotations

import dataclasses
import json
import time
import zipfile
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch
import yaml

from ..checkpoint import (
    load_model_checkpoint,
    load_optimizer_checkpoint,
    save_model_checkpoint,
    save_optimizer_checkpoint,
)
from ..context import BaseContext
from ..data import DataLoader
from ..logging import Logger
from ..optimizer import Optimizer
from ..parallel import ParallelModule
from ..resilience import (
    CheckpointCommit,
    CheckpointCorruptionError,
    checkpoint_candidates,
    prune_manifest_entries,
    retry_io,
    verify_checkpoint,
)

# disk-level corruption a load may skip past; anything else (a shape or
# config mismatch, an out-of-memory) aborts the resume
_CORRUPT_LOAD_ERRORS = (zipfile.BadZipFile, EOFError, OSError, CheckpointCorruptionError,
                        json.JSONDecodeError)

# fields of the JAX TrainerConfig that are not ported: the values that
# leave them off
_NOT_PORTED = {
    "merge_lora_after_loading_checkpoint": (False,),
    "dataloader_prefetch_factor": (None, 0),
    "save_checkpoint_async": (False,),
    "multihost_shared_save_dir": (False,),
    "max_consecutive_nonfinite": (None,),
    "step_timeout_seconds": (None,),
    "checkpoint_backend": ("npz",),
}
# kept for config parity in the JAX package too: no effect there either
_PARITY = ("dataloader_num_workers", "dataloader_pin_memory")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """The ``trainer`` section, under the JAX key names and defaults."""

    save_dir: Optional[str] = None
    save_interval: Optional[int] = None
    load_dir: Optional[str] = None
    train_iterations: Optional[int] = None
    assert_checkpoint_loaded: bool = True
    load_optimizer_states: bool = True
    delete_past_optimizer_states: bool = True
    load_context: bool = True
    allowed_missing_keys_in_checkpoint: Optional[List[str]] = None
    allowed_unexpected_keys_in_checkpoint: Optional[List[str]] = None
    ignore_keys_in_checkpoint: Optional[List[str]] = None
    seed: int = 42
    log_interval: int = 1  # fetch and log the step's metrics every n steps
    eval_iterations: int = 0  # eval micro-batches a pass (at least 1)
    eval_interval: Optional[int] = None
    strict_checkpoint_load: bool = False
    io_retry_attempts: int = 3
    io_retry_backoff_seconds: float = 0.05
    deep_checkpoint_verification: bool = True

    def __post_init__(self):
        if self.log_interval < 1 or self.io_retry_attempts < 1:
            raise ValueError("trainer.log_interval and io_retry_attempts must be >= 1")
        if self.eval_iterations < 0 or self.io_retry_backoff_seconds < 0:
            raise ValueError("trainer.eval_iterations and io_retry_backoff_seconds must be >= 0")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainerConfig":
        d = dict(d)
        for key, off in _NOT_PORTED.items():
            if key in d and d.pop(key) not in off:
                raise NotImplementedError(f"trainer.{key} is not ported")
        for key in _PARITY:
            d.pop(key, None)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown trainer keys: {sorted(unknown)}")
        return cls(**d)


class TrainStepOutput(NamedTuple):
    loss: Any  # a float when fetched, else a device tensor
    metrics: Dict[str, Any]
    global_grad_norm: Any = None
    learning_rates: Optional[Dict[str, float]] = None
    current_loss_scale: Optional[float] = None
    step_duration: Optional[float] = None  # seconds, host clock to the loss's fetch
    fetched: bool = True


class EvaluationStepOutput(NamedTuple):
    loss: float
    metrics: Dict[str, float]


class BaseTrainer:
    """Wires the module, optimizer and datasets; owns the training loop."""

    def __init__(self, config: TrainerConfig, context: BaseContext,
                 parallel_module: ParallelModule, optimizer: Optimizer,
                 loss_function: Callable, logger: Logger, dataset: Any = None,
                 dataset_evaluation: Any = None,
                 batch_to_model_input: Callable[[Any, torch.device], Dict[str, torch.Tensor]]
                 = lambda batch, device: batch):
        self.config = config
        self.context = context
        self.module = parallel_module
        self.optimizer = optimizer
        self.loss_function = loss_function
        self.logger = logger
        self.dataset = dataset
        self.dataset_evaluation = dataset_evaluation
        self.batch_to_model_input = batch_to_model_input
        self.topology = context.topology
        self.device = next(parallel_module.model.parameters()).device
        self.dataloader: Optional[DataLoader] = None
        self.dataloader_evaluation: Optional[DataLoader] = None
        self._train_step: Optional[Callable] = None
        self._unfetched_steps = 0
        self._last_fetch_wall: Optional[float] = None
        # whether the last load took the optimizer state from the checkpoint
        self.optimizer_states_loaded = False

    # ------------------------------------------------------------ lifecycle
    def initialize(self, load_checkpoint: bool = True,
                   load_dir: Optional[Union[Path, str]] = None) -> None:
        self.context.initialize(self.config.seed)
        load_dir = load_dir or self.config.load_dir
        if load_checkpoint and load_dir is not None:
            loaded = self.load_checkpoint(load_dir)
            if self.config.assert_checkpoint_loaded and not loaded:
                raise RuntimeError(f"could not load checkpoint from {load_dir}")
        self._build_dataloaders()
        self._train_step = self.module.build_train_step(self.optimizer, self.loss_function)

    def _loader(self, dataset: Any, consumed: int) -> DataLoader:
        return DataLoader(seed=self.config.seed, consumed_samples=consumed, dataset=dataset,
                          micro_batch_size=self.topology.micro_batch_size,
                          retry_attempts=self.config.io_retry_attempts,
                          retry_backoff=self.config.io_retry_backoff_seconds)

    def _build_dataloaders(self) -> None:
        if self.dataset is not None:
            self.dataloader = self._loader(self.dataset, self.context.consumed_samples)
        if self.dataset_evaluation is not None:
            self.dataloader_evaluation = self._loader(self.dataset_evaluation,
                                                      self.context.consumed_eval_samples)

    # ----------------------------------------------------------- train step
    def _assemble_micro_batches(self) -> Any:
        """The step's ``gas`` micro-batches, stacked on the host."""
        batches = [next(self.dataloader) for _ in range(self.topology.gradient_accumulation_steps)]
        return type(batches[0]).stack(batches)

    def train_step(self) -> TrainStepOutput:
        start = time.time()
        batch = self.batch_to_model_input(self._assemble_micro_batches(), self.device)
        loss, metrics, opt_out = self._train_step(batch)
        self.context.step()
        last_step = (self.config.train_iterations is not None
                     and self.context.iterations >= self.config.train_iterations)
        if not (last_step or self.context.iterations % self.config.log_interval == 0):
            # in flight: the next step is not held up by a host sync
            self._unfetched_steps += 1
            return TrainStepOutput(loss, metrics, opt_out.global_grad_norm,
                                   opt_out.learning_rates, opt_out.current_loss_scale,
                                   step_duration=None, fetched=False)
        loss = float(loss)  # the one host sync of a fetched step
        now = time.time()
        backlog, self._unfetched_steps = self._unfetched_steps, 0
        if backlog and self._last_fetch_wall is not None:
            # a fetch after unfetched steps drains all of them
            step_duration = (now - self._last_fetch_wall) / (backlog + 1)
        else:
            step_duration = now - start
        self._last_fetch_wall = now
        return TrainStepOutput(
            loss=loss,
            metrics={k: float(v) for k, v in metrics.items()},
            global_grad_norm=_maybe(float, opt_out.global_grad_norm),
            learning_rates={k: float(v) for k, v in (opt_out.learning_rates or {}).items()},
            current_loss_scale=_maybe(float, opt_out.current_loss_scale),
            step_duration=step_duration,
        )

    @torch.no_grad()
    def eval_step(self) -> EvaluationStepOutput:
        if self.dataloader_evaluation is None:
            raise RuntimeError("no evaluation dataset")
        self.module.model.eval()
        losses, metric_list = [], []
        for _ in range(max(self.config.eval_iterations, 1)):
            batch = self.batch_to_model_input(next(self.dataloader_evaluation), self.device)
            loss, metrics = self.loss_function(self.module.forward(batch), batch)
            losses.append(float(loss))
            metric_list.append({k: float(v) for k, v in metrics.items()})
            self.context.consumed_eval_samples += self.topology.micro_batch_size
        return EvaluationStepOutput(
            loss=float(np.mean(losses)),
            metrics={k: float(np.mean([m[k] for m in metric_list])) for k in metric_list[0]},
        )

    # --------------------------------------------------------------- loop
    def run_training(self, log_metrics_fn: Optional[Callable] = None) -> None:
        if self.config.train_iterations is None:
            raise ValueError("trainer.train_iterations must be set to run training")
        while self.context.iterations < self.config.train_iterations:
            output = self.train_step()
            it = self.context.iterations
            will_save = (self.config.save_dir is not None and self.config.save_interval
                         is not None and it % self.config.save_interval == 0)
            will_eval = (self.config.eval_interval is not None
                         and self.dataset_evaluation is not None
                         and it % self.config.eval_interval == 0)
            if (will_save or will_eval) and self._unfetched_steps and self.device.type == "cuda":
                # drain the backlog inside the training window, before the
                # save or eval time is taken out of it below
                torch.cuda.synchronize(self.device)
            aux_start = time.time()
            if will_save:
                self.save_checkpoint()
            if will_eval:
                out = self.eval_step()
                self.logger.log_metrics({"eval_loss": out.loss,
                                         **{f"eval_{k}": v for k, v in out.metrics.items()}}, it)
            if (will_save or will_eval) and self._last_fetch_wall is not None:
                self._last_fetch_wall += time.time() - aux_start
            self._emit_step_metrics(output, log_metrics_fn)

    def _emit_step_metrics(self, output: TrainStepOutput,
                           log_metrics_fn: Optional[Callable]) -> None:
        if not output.fetched:
            return
        metrics = {"loss": output.loss, **output.metrics, **(output.learning_rates or {})}
        if output.global_grad_norm is not None:
            metrics["global_grad_norm"] = output.global_grad_norm
        if output.current_loss_scale is not None:
            metrics["loss_scale"] = output.current_loss_scale
        metrics["step_duration"] = output.step_duration
        if log_metrics_fn is not None:
            metrics = log_metrics_fn(self, output, metrics)
        self.logger.log_metrics(metrics, self.context.iterations)

    # --------------------------------------------------------- checkpoints
    def _ckpt_params(self) -> Dict[str, torch.Tensor]:
        """The model's parameters by JAX key."""
        params = dict(self.module.model.named_parameters())
        return {key: params[name] for name, key in self.module.ckpt_keys().items()}

    def _config_dict(self) -> Optional[dict]:
        to_dict = getattr(self.context.config, "to_dict", None)
        return None if to_dict is None else to_dict()

    def save_checkpoint(self, dir: Optional[Union[Path, str]] = None) -> Path:
        """Stage, manifest, fsync and rename onto ``global_step{N}``, then
        move ``latest``; with ``delete_past_optimizer_states`` the older
        checkpoints lose their optimizer files (and manifest entries)."""
        base = Path(dir or self.config.save_dir)
        base.mkdir(parents=True, exist_ok=True)
        config = self._config_dict()
        commit = CheckpointCommit(base, self.context.iterations)
        stage = commit.tmp_dir
        save_model_checkpoint(stage, self._ckpt_params(), recorder=commit.record)
        save_optimizer_checkpoint(stage, self.optimizer, self.module.ckpt_keys(),
                                  recorder=commit.record)
        self.context.save_checkpoint(stage)
        if config is not None:  # the architecture travels with the weights
            (stage / "config.yml").write_text(yaml.safe_dump(config, sort_keys=False))
        step_dir = commit.finalize()
        commit.update_latest()
        self.logger.info(f"saved checkpoint {step_dir}")
        if self.config.delete_past_optimizer_states:
            for old in sorted(base.glob("global_step*")):
                if old == step_dir:
                    continue
                removed = [f.name for f in old.glob("optimizer_state_*")]
                for name in removed:
                    (old / name).unlink()
                if removed:
                    prune_manifest_entries(old, removed)
        return step_dir

    def load_checkpoint(self, dir: Optional[Union[Path, str]] = None) -> bool:
        """Verified restore with fallback: the candidates in order, each
        verified against its manifest and then loaded; a corrupt one is
        skipped (an error with ``strict_checkpoint_load``). Returns whether
        a checkpoint was loaded."""
        base = Path(dir or self.config.load_dir)
        candidates = checkpoint_candidates(base)
        if not candidates:
            self.logger.warning(f"no checkpoint found at {base}")
            return False
        skipped: List[str] = []
        for step_dir in candidates:
            problems = verify_checkpoint(step_dir, deep=self.config.deep_checkpoint_verification)
            if problems:
                line = f"{step_dir.name}: {'; '.join(problems)}"
                if self.config.strict_checkpoint_load:
                    raise CheckpointCorruptionError(
                        f"checkpoint verification failed (strict mode): {line}")
                self.logger.warning(f"skipping invalid checkpoint {line}")
                skipped.append(line)
                continue
            try:
                retry_io(lambda d=step_dir: self._load_step_dir(d),
                         attempts=self.config.io_retry_attempts,
                         base_delay=self.config.io_retry_backoff_seconds,
                         what=f"checkpoint load {step_dir.name}")
            except _CORRUPT_LOAD_ERRORS as e:
                line = f"{step_dir.name}: load failed ({type(e).__name__}: {e})"
                if self.config.strict_checkpoint_load:
                    raise
                self.logger.warning(f"skipping unreadable checkpoint {line}")
                skipped.append(line)
                continue
            if skipped:
                self.logger.warning(f"resumed from {step_dir.name} after skipping "
                                    f"{len(skipped)} checkpoint(s): " + " | ".join(skipped))
            return True
        self.logger.warning(f"no valid checkpoint under {base}; skipped: " + " | ".join(skipped))
        return False

    def _warn_if_config_changed(self, step_dir: Path) -> None:
        """The JAX trainer's warning on a changed config fingerprint, from
        the checkpoint's ``config.yml`` read as the run's config is."""
        current = getattr(self.context, "config", None)
        from_dict = getattr(type(current), "from_dict", None)
        saved = step_dir / "config.yml"
        if from_dict is None or not saved.is_file():
            return
        try:
            changed = from_dict(yaml.safe_load(saved.read_text())) != current
        except (ValueError, NotImplementedError):
            changed = True
        if changed:
            self.logger.warning(f"config changed since {step_dir.name} was saved; expected "
                                "for finetunes/topology changes, suspicious for a plain resume")

    def _load_step_dir(self, step_dir: Path) -> None:
        c = self.config
        self._warn_if_config_changed(step_dir)
        load_model_checkpoint(step_dir, self._ckpt_params(),
                              allowed_missing_keys=c.allowed_missing_keys_in_checkpoint,
                              allowed_unexpected_keys=c.allowed_unexpected_keys_in_checkpoint,
                              ignore_keys=c.ignore_keys_in_checkpoint)
        self.optimizer_states_loaded = False
        if c.load_optimizer_states:
            try:
                load_optimizer_checkpoint(step_dir, self.optimizer, self.module.ckpt_keys())
                self.optimizer_states_loaded = True
            except FileNotFoundError:
                self.logger.warning(f"optimizer states absent in {step_dir}")
        if not self.optimizer_states_loaded:
            # the masters were copied from the random init: take them from
            # the loaded parameters, or the first step would revert the model
            self.optimizer.state = self.optimizer.init_state()
        if c.load_context:
            self.context.load_checkpoint(step_dir)
            mbs = self.topology.micro_batch_size
            if self.context.consumed_samples % mbs:
                raise ValueError(f"consumed_samples {self.context.consumed_samples} of "
                                 f"{step_dir} is not a multiple of micro_batch_size {mbs}")
            self.context.consumed_eval_samples -= self.context.consumed_eval_samples % mbs
        self.logger.info(f"loaded checkpoint {step_dir}")


def _maybe(cast: Callable, v: Any) -> Any:
    return None if v is None else cast(v)
