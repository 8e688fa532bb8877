"""The training loop, its checkpoints and its supervision, on one rank or
on each rank of a data x model layout (counterpart of
scaling_tpu/trainer/trainer.py).

``run_training`` drives: train step -> periodic save -> periodic eval ->
metric logging, for ``train_iterations`` steps. Checkpoints follow the
JAX package's layout: ``save_dir/global_step{N}/`` with the model and
optimizer npz files, ``context.json``, ``config.yml``, ``MESH.json``,
``vocab.json`` when the architecture names a ``vocab_file``, and
``MANIFEST.json``, committed atomically, then ``latest``. With
``save_checkpoint_async`` the save takes its host copies and returns
while one writer thread serialises, writes, commits and prunes.
``load_checkpoint`` takes the newest candidate that verifies (``latest``
first), skipping corrupt ones unless ``strict_checkpoint_load``, with
``merge_lora_after_loading_checkpoint`` folds the LoRA deltas into the
base weights after the load (the optimizer then starts afresh from the
merged weights, as in the JAX trainer: the checkpoint's masters hold the
unmerged ones),
pre-flights the checkpoint's ``MESH.json`` against the model's global
shapes, and warns when the checkpoint's ``config.yml`` reads to another
config than the run's, where the JAX trainer warns that its config
fingerprint changed. The manifest carries no fingerprint: the JAX one is
a digest of the JAX config's full dump, every default included, which
the port does not rebuild.

Supervision, as in the JAX trainer: SIGTERM
(``install_preemption_handler``) saves at the step boundary and returns;
``max_consecutive_nonfinite`` bounds a streak of non-finite losses, then
saves and raises ``NonFiniteLossError``; ``step_timeout_seconds`` arms a
stall watchdog after the first step that requests the same save-and-exit;
the ``SCALING_TPU_FAULTS`` points ``signal.sigterm``, ``host.kill`` and
``host.hang`` fire at the top of each iteration and ``step.nan_grads``
after each step. Under the supervisor (``attach_control_plane``) each
iteration publishes a heartbeat (``starting``, ``running``, then
``preempted`` or ``done``), raises ``JobAborted`` on the abort flag,
broadcasts and obeys the preempt flag, and with several hosts meets the
others at a ``step-N`` barrier; a save meets them at ``commit:step-N``
before ``latest`` moves; a stall sets the stall flag beside a straggler
table's verdict.

Each step draws its dropout masks from the key ``(seed, "dropout",
iteration)`` (``nn.base_layer.dropout_key``, the JAX trainer's
``rng.key("dropout", iterations)``), so a resumed run draws the masks of
the run it resumes.

Micro-batches are stacked ``(gas, mbs, s)`` on the host, by a prefetch
thread with ``dataloader_prefetch_factor`` > 0, and moved to the device
in one copy per step on the loop's thread (``batch_to_model_input``).
The orbax backend is not ported: ``checkpoint_backend`` raises
NotImplementedError at any value but the default.

Over several ranks (``ParallelModule.layout``), as JAX's single
controller does: each data rank reads its rows of every global
micro-batch and ``consumed_samples`` stays global; global rank 0 alone
writes the checkpoint (every leaf gathered whole, JAX's merged layout,
``MESH.json`` naming the layout and the ZeRO stage), and the others wait
at a barrier until ``latest`` is durable; a load gives each rank its
slices and rescales the cursors to the run's layout; a SIGTERM to any
rank becomes every rank's save at the same step through one all-reduce
of the flags at each step boundary, so no rank waits in a collective
that a peer left. Records, events and step metrics come from rank 0
(``logger``'s rank). Over several pipe stages every stage reads the same
micro-batches of its data rank, the step hands the last stage's loss and
metrics to every stage (so rank 0's records carry them), the save gathers
every stage's leaves to rank 0 (the files are the one-rank model's at any
pipe layout), a load gives each stage its own leaves, and the run logs the
``pipeline-config`` event (with its token slices) that ``obs report``'s
pipeline section reads. Under context parallelism the context ranks of a
data rank read the same micro-batches and each trains on its slice of the
sequence (``ParallelModule``); the parameters are replicated over them, so
the save gathers from context rank 0's groups and a load gives every
context rank the same leaves. ``MESH.json`` carries the real
``context_parallel_size`` and ``pipe_token_slices``.

Observability, as in the JAX trainer: the spans ``step.data``,
``step.fwdbwd`` (host dispatch only: the device work shows in
``step.sync``, which holds the loss's fetch), ``step.sync``,
``trainer.eval``, ``trainer.save``, ``ckpt.stage`` and ``ckpt.latest``;
``self.telemetry`` (``obs.StepTelemetry``) merges its gauges into each
fetched step's record and flushes the registry after it; a ``Profiler``
times the steps of its window, each of which synchronises, and may trace
the window with ``torch.profiler``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import signal
import threading
import time
import zipfile
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Set, Union

import numpy as np
import torch
import yaml

from ..checkpoint import (
    AsyncCheckpointWriter,
    load_model_checkpoint,
    load_optimizer_checkpoint,
    save_model_checkpoint,
    save_optimizer_checkpoint,
)
from ..context import BaseContext
from ..data import DataLoader
from ..logging.logger import logger
from ..nn.base_layer import dropout_key
from ..parallel.collectives import any_rank, barrier, gather_objects
from ..obs import StepTelemetry, derive_trace_id, span, trace_context
from ..optimizer import Optimizer
from ..parallel import ParallelModule
from ..parallel.parallel_module import jax_partition_spec, to_jax_layout
from ..resilience import (
    CheckpointCommit,
    CheckpointCorruptionError,
    ControlPlane,
    JobAborted,
    NonFiniteGuard,
    NonFiniteLossError,
    StepStallWatchdog,
    build_mesh_meta,
    checkpoint_candidates,
    fire_reshard_point,
    get_fault_plan,
    param_record,
    prune_manifest_entries,
    read_manifest,
    read_mesh_meta,
    rescale_consumed_samples,
    reshard_plan,
    retry_io,
    straggler_table,
    verify_checkpoint,
    write_mesh_meta,
)
from ..resilience.controlplane import (
    ABORT_FLAG,
    ENV_COORD_EPOCH,
    ENV_NUM_HOSTS,
    PREEMPT_FLAG,
    STALL_FLAG,
)
from ..tune import prediction_from_env

# disk-level corruption a load may skip past; anything else (a shape or
# config mismatch, an out-of-memory) aborts the resume
_CORRUPT_LOAD_ERRORS = (zipfile.BadZipFile, EOFError, OSError, CheckpointCorruptionError,
                        json.JSONDecodeError)

# fields of the JAX TrainerConfig that are not ported: the values that
# leave them off
_NOT_PORTED = {
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
    # micro-batch stacks assembled ahead on a thread; None or 0: synchronously
    dataloader_prefetch_factor: Optional[int] = None
    save_checkpoint_async: bool = False  # files written on a thread after the host copies
    # consecutive non-finite steps tolerated before save-and-abort; None: off
    max_consecutive_nonfinite: Optional[int] = None
    step_timeout_seconds: Optional[float] = None  # stall watchdog; None: off
    # under a control plane: one checkpoint tree shared by every host, whose
    # ``latest`` host 0 alone moves; False: each host owns its pointer
    multihost_shared_save_dir: bool = False
    merge_lora_after_loading_checkpoint: bool = False

    def __post_init__(self):
        if self.log_interval < 1 or self.io_retry_attempts < 1:
            raise ValueError("trainer.log_interval and io_retry_attempts must be >= 1")
        if self.eval_iterations < 0 or self.io_retry_backoff_seconds < 0:
            raise ValueError("trainer.eval_iterations and io_retry_backoff_seconds must be >= 0")
        for key in ("dataloader_prefetch_factor", "max_consecutive_nonfinite"):
            if getattr(self, key) is not None and getattr(self, key) < 0:
                raise ValueError(f"trainer.{key} must be >= 0")
        if self.step_timeout_seconds is not None and not self.step_timeout_seconds > 0:
            raise ValueError("trainer.step_timeout_seconds must be > 0")

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
    overflow: Any = None  # a bool when fetched
    no_overflow_steps: Optional[int] = None


class EvaluationStepOutput(NamedTuple):
    loss: float
    metrics: Dict[str, float]


class BaseTrainer:
    """Wires the module, optimizer and datasets; owns the training loop."""

    def __init__(self, config: TrainerConfig, context: BaseContext,
                 parallel_module: ParallelModule, optimizer: Optimizer,
                 loss_function: Callable, dataset: Any = None,
                 dataset_evaluation: Any = None,
                 batch_to_model_input: Callable[[Any, torch.device], Dict[str, torch.Tensor]]
                 = lambda batch, device: batch,
                 profiler: Any = None):
        self.config = config
        self.context = context
        self.module = parallel_module
        self.optimizer = optimizer
        self.loss_function = loss_function
        self.dataset = dataset
        self.dataset_evaluation = dataset_evaluation
        self.batch_to_model_input = batch_to_model_input
        self.profiler = profiler
        self.topology = context.topology
        self.device = next(parallel_module.model.parameters()).device
        # the run's Topology over several ranks (None: one rank)
        self.layout = parallel_module.layout
        if self.layout is not None and config.save_checkpoint_async:
            raise NotImplementedError("trainer.save_checkpoint_async over several ranks is "
                                      "not ported")
        self.dataloader: Optional[DataLoader] = None
        self.dataloader_evaluation: Optional[DataLoader] = None
        self._train_step: Optional[Callable] = None
        self._unfetched_steps = 0
        self._last_fetch_wall: Optional[float] = None
        # whether the last load took the optimizer state from the checkpoint,
        # and the JAX keys of the parameters it took from the checkpoint
        self.optimizer_states_loaded = False
        self.restored_model_keys: Set[str] = set()
        self._ckpt_writer: Optional[AsyncCheckpointWriter] = None
        self._prefetch_queue: Optional[queue.Queue] = None
        self._prefetch_thread: Optional[threading.Thread] = None
        self._prefetch_stop: Optional[threading.Event] = None
        # cluster hook points: a preemption predicate polled after every
        # step, metric sinks called after logging, checkpoint sinks called
        # with each durable step directory
        self.external_preemption: Optional[Callable[[], bool]] = None
        self.metrics_hooks: List[Callable[[dict, int], None]] = []
        self.checkpoint_hooks: List[Callable[[Path, int], None]] = []
        self._preempted = False
        self._last_saved_step: Optional[int] = None
        self._nonfinite_guard = (None if config.max_consecutive_nonfinite is None
                                 else NonFiniteGuard(config.max_consecutive_nonfinite))
        self.watchdog: Optional[StepStallWatchdog] = None  # the last run_training's
        # the supervision control plane (attach_control_plane)
        self._control_plane: Optional[ControlPlane] = None
        self._cp_first_checkin = True
        self._cp_step_barrier = True
        self._cp_barrier_timeout = 300.0
        self._cp_peer_stale = 60.0
        self._cp_latest_leader = True
        self._cp_prev_commit_step: Optional[int] = None
        # per-step telemetry: hardware gauges, the step-time EMA and, once
        # configure() declared the model's FLOPs per token, achieved TFLOPs
        # and MFU; host-side only by contract
        self.telemetry = StepTelemetry()

    # ------------------------------------------------------------ lifecycle
    def initialize(self, load_checkpoint: bool = True,
                   load_dir: Optional[Union[Path, str]] = None) -> None:
        # a second initialize rebuilds the loaders: the running prefetch
        # worker reads them, so it stops first
        self.stop_prefetch()
        self.context.initialize(self.config.seed)
        load_dir = load_dir or self.config.load_dir
        if load_checkpoint and load_dir is not None:
            loaded = self.load_checkpoint(load_dir)
            if self.config.assert_checkpoint_loaded and not loaded:
                raise RuntimeError(f"could not load checkpoint from {load_dir}")
        self._build_dataloaders()
        self._train_step = self.module.build_train_step(self.optimizer, self.loss_function)
        if (self.config.dataloader_prefetch_factor or 0) > 0 and self.dataloader is not None:
            self._start_prefetch(self.config.dataloader_prefetch_factor)

    def _start_prefetch(self, depth: int) -> None:
        """A daemon thread that keeps up to ``depth`` micro-batch stacks
        ready. It runs for the trainer's lifetime: every queued stack is
        consumed in order by later steps, so the stream is the synchronous
        one, and ``consumed_samples`` advances as a step takes a stack
        (``context.step``), never as the thread assembles one. Stacks
        assembled but not consumed are rebuilt by a resume."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()
        self._prefetch_queue, self._prefetch_stop = q, stop

        def worker():
            # closure locals: stop_prefetch clears the attributes while an
            # assembly may still be in flight
            while not stop.is_set():
                try:
                    item = self._assemble_micro_batches()
                except BaseException as e:  # raised on the loop's thread instead
                    item = e
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if isinstance(item, BaseException):
                    if stop.is_set():
                        logger.warning(f"batch prefetch error during shutdown: {item!r}")
                    return

        self._prefetch_thread = threading.Thread(target=worker, name="batch-prefetch",
                                                 daemon=True)
        self._prefetch_thread.start()

    def stop_prefetch(self) -> None:
        """Stop the prefetch thread and drop its queued stacks: only for a
        trainer that will not train again."""
        if self._prefetch_stop is not None:
            self._prefetch_stop.set()
        if self._prefetch_thread is not None:
            self._prefetch_thread.join(timeout=5)
        self._prefetch_queue = self._prefetch_thread = self._prefetch_stop = None

    def _loader(self, dataset: Any, consumed: int) -> DataLoader:
        lay = self.layout
        return DataLoader(seed=self.config.seed, consumed_samples=consumed, dataset=dataset,
                          micro_batch_size=self.topology.micro_batch_size,
                          retry_attempts=self.config.io_retry_attempts,
                          retry_backoff=self.config.io_retry_backoff_seconds,
                          data_parallel_size=1 if lay is None else lay.data_parallel_size,
                          dp_rank=0 if lay is None else lay.data_parallel_rank)

    # Deliberately lock-free: ``dataloader`` is assigned here BEFORE
    # ``_start_prefetch`` spawns the worker (thread start happens-before
    # publishes it) and never reassigned while a worker is live
    # (``initialize`` stops a running one first, ``stop_prefetch`` joins it).
    # sta: lock(dataloader)
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

    def _next_micro_batches(self) -> Any:
        if self._prefetch_queue is not None:
            item = self._prefetch_queue.get()
            if isinstance(item, BaseException):
                self.stop_prefetch()
                raise item
            return item
        return self._assemble_micro_batches()

    def train_step(self) -> TrainStepOutput:
        step_idx = self.context.iterations
        profiling = self.profiler is not None and self.profiler.enabled_at(step_idx)
        if profiling and self._unfetched_steps:
            # the window opens on a drained device queue, or its first
            # step_time absorbs the unfetched backlog
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # sta: disable=STA010
            self._unfetched_steps = 0
            self._last_fetch_wall = time.time()
        if self.profiler is not None:
            self.profiler.begin_step(step_idx)
        start = time.time()
        with span("step.data", step=step_idx):
            batch = self.batch_to_model_input(self._next_micro_batches(), self.device)
        t_data = time.time() - start
        # a dispatch span: it closes once the step's kernels are queued
        with span("step.fwdbwd", step=step_idx):
            loss, metrics, opt_out = self._train_step(
                batch, dropout_key(self.context.seed, self.context.iterations))
        if get_fault_plan().fire("step.nan_grads") == "nan":
            # a transient NaN burst for the non-finite policy: only the
            # observed loss is poisoned, the parameters stay clean
            loss = torch.full((), float("nan"), device=loss.device)
        self.context.step()
        last_step = (self.config.train_iterations is not None
                     and self.context.iterations >= self.config.train_iterations)
        # a profiled step always fetches: its time must cover the device work
        if not (profiling or last_step
                or self.context.iterations % self.config.log_interval == 0):
            # in flight: the next step is not held up by a host sync
            self._unfetched_steps += 1
            return TrainStepOutput(loss, metrics, opt_out.global_grad_norm,
                                   opt_out.learning_rates, opt_out.current_loss_scale,
                                   step_duration=None, fetched=False,
                                   overflow=opt_out.overflow,
                                   no_overflow_steps=opt_out.no_overflow_steps)
        with span("step.sync", step=step_idx):
            # the one host sync of a fetched step
            loss = float(loss)  # sta: disable=STA010
        now = time.time()
        backlog, self._unfetched_steps = self._unfetched_steps, 0
        if backlog and self._last_fetch_wall is not None:
            # a fetch after unfetched steps drains all of them
            step_duration = (now - self._last_fetch_wall) / (backlog + 1)
        else:
            step_duration = now - start
        self._last_fetch_wall = now
        if self.profiler is not None:
            self.profiler.record(step_idx, {"data_load": t_data,
                                            "step_time": step_duration - t_data})
            self.profiler.end_step(step_idx)
        return TrainStepOutput(
            loss=loss,
            metrics={k: float(v) for k, v in metrics.items()},
            global_grad_norm=_maybe(float, opt_out.global_grad_norm),
            learning_rates={k: float(v) for k, v in (opt_out.learning_rates or {}).items()},
            current_loss_scale=_maybe(float, opt_out.current_loss_scale),
            step_duration=step_duration,
            overflow=_maybe(bool, opt_out.overflow),
            no_overflow_steps=_maybe(int, opt_out.no_overflow_steps),
        )

    def eval_step(self) -> EvaluationStepOutput:
        with span("trainer.eval", step=self.context.iterations):
            return self._eval_step_inner()

    @torch.no_grad()
    def _eval_step_inner(self) -> EvaluationStepOutput:
        if self.dataloader_evaluation is None:
            raise RuntimeError("no evaluation dataset")
        self.module.model.eval()
        losses, metric_list = [], []
        for _ in range(max(self.config.eval_iterations, 1)):
            batch = self.batch_to_model_input(next(self.dataloader_evaluation), self.device)
            loss, metrics = self.module.eval_loss(batch, self.loss_function)
            losses.append(float(loss))
            metric_list.append({k: float(v) for k, v in metrics.items()})
            self.context.consumed_eval_samples += (self.topology.micro_batch_size
                                                   * self.topology.data_parallel_size)
        return EvaluationStepOutput(
            loss=float(np.mean(losses)),
            metrics={k: float(np.mean([m[k] for m in metric_list])) for k in metric_list[0]},
        )

    # ------------------------------------------------------ control plane
    def attach_control_plane(self, cp: ControlPlane, *, step_barrier: bool = True,
                             barrier_timeout_s: float = 300.0, peer_stale_s: float = 60.0,
                             shared_save_dir: bool = False) -> None:
        """Join a supervision control plane. Each iteration then publishes
        a heartbeat, obeys the supervisor's ``abort`` flag (exit, not a
        hang in a collective whose peer is gone), broadcasts and observes
        the ``preempt`` flag (one host's SIGTERM becomes every host's save
        at the same step boundary) and, with ``step_barrier`` and several
        hosts, meets the others at ``step-N``. A save meets them at
        ``commit:step-N`` before ``latest`` moves; with ``shared_save_dir``
        (one tree for every host) only host 0 moves it."""
        if not step_barrier and cp.num_hosts > 1:
            # nothing then bounds the skew: a drain may end with hosts
            # saving at different steps, parked in commit barriers
            logger.warning(f"attach_control_plane(step_barrier=False) on a {cp.num_hosts}-host "
                           "plane: coordinated preemption cannot guarantee a same-step boundary "
                           "and commit barriers may time out during a drain")
        self._control_plane = cp
        self._cp_step_barrier = step_barrier
        self._cp_barrier_timeout = barrier_timeout_s
        self._cp_peer_stale = peer_stale_s
        self._cp_latest_leader = (not shared_save_dir) or cp.host_id == 0

    def _control_plane_checkin(self) -> bool:
        """The top of an iteration: True when this host exits at this
        boundary (its own preemption decided before the step barrier, or a
        peer's broadcast seen before or after it). A SIGTERM that lands
        inside the barrier wait comes too late for this boundary (peers
        may already wait at the next), so that host runs one more step and
        exits on the post-step path, where its broadcast and arrival
        release the others at the same boundary."""
        cp = self._control_plane
        if cp is None:
            # over several ranks a flag is obeyed only where the ranks agree
            # on it, after a step (_preemption_requested)
            return self._preempted and self.layout is None
        step = self.context.iterations
        # the first iteration still builds and loads the kernels: the
        # supervisor's startup grace applies to ``starting``
        cp.heartbeat(step, status="starting" if self._cp_first_checkin else "running")
        self._cp_first_checkin = False
        if cp.get_flag(ABORT_FLAG) is not None:
            logger.log_event("abort-observed", host=cp.host_id, step=step)
            raise JobAborted("supervisor raised the abort flag: a peer host is gone, so "
                             "barriers/collectives can never complete — exiting without a save "
                             "(the last committed checkpoint stands)")
        if not self._preempted and cp.get_flag(PREEMPT_FLAG) is not None:
            self._preempted = True
        if self._preempted:
            # the flag and this boundary's arrival release a peer already
            # waiting; the save's commit barrier is the real rendezvous
            self._broadcast_preempt(step)
            return True
        if self._cp_step_barrier and cp.num_hosts > 1:
            cp.barrier(f"step-{step}", self._cp_barrier_timeout)
            if step >= 2 and cp.host_id == 0:
                # every host passed step-{step}: none waits on step-{step-2}
                cp.prune_barrier(f"step-{step - 2}")
            if cp.get_flag(PREEMPT_FLAG) is not None:
                # the broadcaster arrived at this barrier: its boundary
                self._preempted = True
                return True
        return False

    def _broadcast_preempt(self, step: int) -> None:
        """Make this host's preemption every host's without stranding a
        peer: the preempt flag (once), then this boundary's step-barrier
        arrival. The flag comes first, so a peer released by the arrival
        sees it."""
        cp = self._control_plane
        if cp is None:
            return
        if cp.get_flag(PREEMPT_FLAG) is None:
            cp.set_flag(PREEMPT_FLAG, str(step))
            logger.log_event("preempt-broadcast", host=cp.host_id, step=step)
        if self._cp_step_barrier and cp.num_hosts > 1:
            cp.arrive(f"step-{step}")

    def _commit_barrier_and_latest(self, commit: CheckpointCommit) -> None:
        """``latest`` moves once every host committed its part of this step
        (``commit:step-N``): a host killed in between leaves every
        ``latest`` at the previous step, so no restore mixes steps. On the
        asynchronous path this runs on the writer's thread after the
        commit, in the synchronous path's order."""
        cp = self._control_plane
        if cp is not None and cp.num_hosts > 1:
            get_fault_plan().fire("ckpt.commit_barrier", path=commit.final_dir)
            # every host derives the same trace from the commit's identity
            # (an epoch's re-save of a step is another incident)
            commit_trace = derive_trace_id("ckpt-commit", commit.step,
                                           os.environ.get(ENV_COORD_EPOCH, "0"))
            with trace_context(commit_trace):
                with span("ckpt.commit_barrier", step=commit.step, host=cp.host_id):
                    cp.barrier(f"commit:step-{commit.step}", self._cp_barrier_timeout)
            prev = self._cp_prev_commit_step
            if prev is not None and prev != commit.step and cp.host_id == 0:
                # every host passed this commit barrier; the current one's
                # arrivals stay for a preemption's re-save of the same step
                cp.prune_barrier(f"commit:step-{prev}")
            self._cp_prev_commit_step = commit.step
        if self._cp_latest_leader:
            with span("ckpt.latest", step=commit.step):
                commit.update_latest()

    def _heartbeat(self, status: str = "running") -> None:
        if self._control_plane is not None:
            self._control_plane.heartbeat(self.context.iterations, status=status)

    # --------------------------------------------------------- preemption
    def install_preemption_handler(self) -> None:
        """Save and exit at the step boundary on SIGTERM (spot and
        preemptible machines send it before reclaiming); the next run
        resumes from the saved step. Chains to the handler installed
        before it. Call from the main thread."""
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            self._preempted = True
            if callable(prev):  # SIG_DFL and SIG_IGN are not callable
                prev(signum, frame)

        self._preempted = False
        signal.signal(signal.SIGTERM, handler)

    def _preemption_requested(self) -> bool:
        if not self._preempted and self._control_plane is not None:
            # another host broadcast a preemption since the last check
            if self._control_plane.get_flag(PREEMPT_FLAG) is not None:
                self._preempted = True
        requested = self._preempted or (self.external_preemption is not None
                                        and self.external_preemption())
        if self.layout is not None:
            # every rank asks at every step boundary: one rank's SIGTERM is
            # every rank's save at this step
            requested = any_rank(requested, self.layout.host_group)
            self._preempted = self._preempted or requested
        return requested

    def _preemption_exit(self) -> None:
        # a SIGTERM during the step passed no checkin: broadcast (and
        # release a peer at this boundary) before the save's commit barrier
        self._broadcast_preempt(self.context.iterations)
        if self.config.save_dir is not None and self._last_saved_step == self.context.iterations:
            # the periodic save just took this boundary: drain it, do not
            # write it again on a reclaim's deadline
            self.finalize_checkpoints()
            logger.info("preemption: boundary already checkpointed, exiting cleanly")
        elif self.config.save_dir is not None:
            # the last heartbeat was a step ago: the timeout budgets the save
            self._heartbeat()
            step_dir = self.save_checkpoint()
            self.finalize_checkpoints()
            self._run_checkpoint_hooks(step_dir)
            logger.info("preemption: checkpoint saved, exiting cleanly")
        self._heartbeat("preempted")

    def _on_step_stall(self, step: int, elapsed: float) -> None:
        """The watchdog's callback, on its thread: the state cannot be
        copied mid-step, so it requests the save-and-exit of a preemption
        at the next loop boundary, if the stalled step ever ends. With a
        control plane, the peers' heartbeats give the verdict: a peer that
        stopped publishing is dead (``peer-host-dead``), else the stall is
        local; the stall flag tells the supervisor that the drain to come
        is not the end of the run."""
        verdict, dead = "local-stall", []
        cp = self._control_plane
        if cp is not None:
            try:
                report = straggler_table(cp.peer_heartbeats(), cp.num_hosts, self._cp_peer_stale)
            # ValueError: a truncated TCP reply; the request below must go out
            except (OSError, RuntimeError, ValueError) as e:
                logger.warning(f"peer heartbeat read failed mid-stall: {e!r}")
            else:
                # this host's own heartbeat is stale mid-stall by necessity
                dead = [h for h in report.dead_hosts if h != cp.host_id]
                if dead:
                    verdict = "peer-host-dead"
                logger.error(f"stall straggler table (stale after {self._cp_peer_stale}s):\n"
                             f"{report.render()}")
        logger.log_event("step-stall", step=step, elapsed_s=round(elapsed, 1), verdict=verdict,
                         dead_hosts=dead, host=cp.host_id if cp is not None else 0)
        logger.error(f"step stall after step {step} ({elapsed:.1f}s, {verdict}): "
                     "requesting save-and-exit at the next loop boundary")
        if cp is not None:
            try:
                cp.set_flag(STALL_FLAG, str(step))
            except (OSError, RuntimeError, ValueError) as e:
                logger.warning(f"stall flag broadcast failed: {e!r}")
        self._preempted = True

    # --------------------------------------------------------------- loop
    def run_training(self, log_metrics_fn: Optional[Callable] = None) -> None:
        if self.config.train_iterations is None:
            raise ValueError("trainer.train_iterations must be set to run training")
        topo = self.topology
        if topo.pipe_parallel_size > 1:
            # the schedule's shape, which obs report's pipeline section reads
            logger.log_event("pipeline-config", pp=topo.pipe_parallel_size,
                             virtual=topo.pipe_virtual_size,
                             token_slices=topo.pipe_token_slices,
                             gas=topo.gradient_accumulation_steps)
        # the tuner's predicted step time for this run's layout (exported by
        # ``python -m scaling_tpu_torch.tune`` as SCALING_TPU_TUNER_PREDICTION),
        # logged into the run's events so ``obs report`` scores prediction
        # against span-measured step time
        prediction = prediction_from_env()
        if prediction is not None:
            logger.log_event("tuner-prediction", **prediction)
        # armed by the loop after the first step: the kernels' first-use
        # builds must not read as a stall
        self.watchdog = (None if self.config.step_timeout_seconds is None else
                         StepStallWatchdog(self.config.step_timeout_seconds,
                                           on_stall=self._on_step_stall))
        try:
            self._run_training_loop(log_metrics_fn)
        finally:
            if self.watchdog is not None:
                self.watchdog.stop()
            if self.profiler is not None:
                # an aborted run keeps its partial window and stops its trace
                self.profiler.close()

    def _run_training_loop(self, log_metrics_fn: Optional[Callable]) -> None:
        watchdog, armed = self.watchdog, False
        while self.context.iterations < self.config.train_iterations:
            if armed:
                watchdog.beat(self.context.iterations)
            for point in ("signal.sigterm", "host.kill", "host.hang"):
                get_fault_plan().fire(point)
            # the heartbeat, the abort and preempt flags and the step
            # barrier; True: a SIGTERM that landed in the save or eval
            # window (or a peer's broadcast) exits here, without a step
            if self._control_plane_checkin():
                self._preemption_exit()
                return
            output = self.train_step()
            if watchdog is not None and not armed:
                armed = True
                watchdog.start()
            it = self.context.iterations
            if self._preemption_requested() and it < self.config.train_iterations:
                # the step just taken is saved by the exit: its metrics go
                # out first. The last boundary takes the normal exit.
                self._emit_step_metrics(output, log_metrics_fn)
                self._preemption_exit()
                return
            will_save = (self.config.save_dir is not None and self.config.save_interval
                         is not None and it % self.config.save_interval == 0)
            will_eval = (self.config.eval_interval is not None
                         and self.dataset_evaluation is not None
                         and it % self.config.eval_interval == 0)
            if (will_save or will_eval) and self._unfetched_steps and self.device.type == "cuda":
                # drain the backlog inside the training window, before the
                # save or eval time is taken out of it below
                torch.cuda.synchronize(self.device)  # sta: disable=STA010
            if will_save or will_eval:
                # the window publishes no heartbeat: the timeout budgets
                # the window itself, not a step and the window
                self._heartbeat()
            aux_start = time.time()
            if will_save:
                self._run_checkpoint_hooks(self.save_checkpoint())
            if will_eval:
                out = self.eval_step()
                logger.log_metrics({"eval_loss": out.loss,
                                         **{f"eval_{k}": v for k, v in out.metrics.items()}}, it)
            if (will_save or will_eval) and self._last_fetch_wall is not None:
                self._last_fetch_wall += time.time() - aux_start
            self._emit_step_metrics(output, log_metrics_fn)
            if self._nonfinite_guard is not None and output.fetched:
                # after logging, so the aborting step's record is written;
                # fetched steps only: an unfetched one would need a sync
                try:
                    self._nonfinite_guard.observe(it, output.loss, output.overflow,
                                                  output.current_loss_scale)
                except NonFiniteLossError:
                    if self.config.save_dir is not None:  # leave a resumable state
                        step_dir = self.save_checkpoint()
                        self.finalize_checkpoints()
                        self._run_checkpoint_hooks(step_dir)
                        logger.error(f"non-finite abort: state saved to {step_dir}")
                    raise
        self.finalize_checkpoints()
        # the supervisor's table reads "done", not a stale "running"
        self._heartbeat("done")

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
        try:  # host-side gauges only: no device sync
            metrics.update(self.telemetry.on_step(self.context.iterations,
                                                  output.step_duration))
        except Exception as e:  # a metrics sink must never abort a step
            logger.warning(f"step telemetry update failed: {e!r}")
        logger.log_metrics(metrics, self.context.iterations)
        self.telemetry.flush(self.context.iterations)
        for hook in self.metrics_hooks:
            try:
                hook(metrics, self.context.iterations)
            except Exception as e:  # reporting must never abort a step
                logger.warning(f"metrics hook failed: {e}")

    def _run_checkpoint_hooks(self, step_dir: Path) -> None:
        if not self.checkpoint_hooks:
            return
        self.finalize_checkpoints()  # hooks see a durable checkpoint
        for hook in self.checkpoint_hooks:
            try:
                hook(step_dir, self.context.iterations)
            except Exception as e:
                logger.warning(f"checkpoint hook failed: {e}")

    def finalize_checkpoints(self) -> None:
        """Block until the asynchronous writes are durable and ``latest``
        names the newest save; re-raises the writer's first failure. The
        prefetch thread keeps running: the trainer may train on."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()

    # --------------------------------------------------------- checkpoints
    def _ckpt_params(self) -> Dict[str, torch.Tensor]:
        """The model's parameters by JAX key."""
        params = dict(self.module.model.named_parameters())
        return {key: params[name] for name, key in self.module.ckpt_keys().items()}

    def _config_dict(self) -> Optional[dict]:
        to_dict = getattr(self.context.config, "to_dict", None)
        return None if to_dict is None else to_dict()

    def _vocab_file(self) -> Optional[Path]:
        config = getattr(self.context, "config", None)
        vocab = getattr(getattr(config, "transformer_architecture", None), "vocab_file", None)
        return Path(vocab) if vocab and Path(vocab).is_file() else None

    def _current_topology_dict(self) -> dict:
        """The JAX trainer's topology record."""
        t = self.topology
        return {"world_size": t.world_size, "pipe_parallel_size": t.pipe_parallel_size,
                "data_parallel_size": t.data_parallel_size,
                "context_parallel_size": t.context_parallel_size,
                "model_parallel_size": t.model_parallel_size,
                "pipe_virtual_size": t.pipe_virtual_size,
                "pipe_token_slices": t.pipe_token_slices, "micro_batch_size": t.micro_batch_size,
                "gradient_accumulation_steps": t.gradient_accumulation_steps,
                "global_batch_size": t.global_batch_size, "num_hosts": self._num_hosts()}

    def _num_hosts(self) -> int:
        """The hosts of the run: the control plane's when one is attached,
        else the supervisor's environment, else 1."""
        if self._control_plane is not None:
            return self._control_plane.num_hosts
        return int(os.environ.get(ENV_NUM_HOSTS, "1"))

    def _param_records(self, params: Dict[str, torch.Tensor]) -> dict:
        """JAX key -> global shape in the JAX layout, dtype and the JAX
        partition spec, for ``MESH.json`` (over several pipe stages every
        stage's leaves, from the whole stack)."""
        shapes = {lay.key: lay.shape for lay in self.module.layouts.values()}
        if self.module.plan is not None:
            whole = dict(self.module.whole_model.named_parameters())
            params = {key: whole[name] for name, key in self.module.whole_ckpt_keys().items()}
        records = {}
        for key, t in params.items():
            whole = torch.empty(shapes.get(key, t.shape), device="meta")
            records[key] = param_record(tuple(to_jax_layout(key, whole).shape),
                                        str(t.dtype).removeprefix("torch."),
                                        jax_partition_spec(key, t.ndim))
        return records

    def _mesh_meta(self, params: Dict[str, torch.Tensor]) -> dict:
        opt = self.optimizer.config
        return build_mesh_meta(
            topology=self._current_topology_dict(), params=self._param_records(params),
            optimizer={"zero_stage": int(opt.zero_stage) if opt.zero else 0,
                       "fields": ["master", "exp_avg", "exp_avg_sq"],
                       "layout": "global-per-layer"},
            step=self.context.iterations)

    def _leaf_gather(self, state: bool):
        """The checkpoint's gather of each leaf by JAX key (``state``: of the
        optimizer's slices) over several ranks; None on one rank. A leaf of
        another pipe stage comes as None; an optimizer state no stage keeps
        (a frozen leaf) is None everywhere."""
        if self.layout is None:
            return None
        names = {key: name for name, key in self.module.whole_ckpt_keys().items()}
        zero = self.optimizer.zero_dims
        optimized = self._optimized_by_any_stage() if state else None

        def gather(key: str, t: Optional[torch.Tensor]):
            name = names[key]
            if state and name not in optimized:
                return None
            return self.module.gather_leaf(name, t, zero.get(name) if state else None,
                                           torch.float32 if state else None)
        return gather

    def _optimized_by_any_stage(self) -> set:
        """The optimised parameters' names over the pipe (one exchange of
        names among its stages; this rank's own at one stage)."""
        every = gather_objects(sorted(self.optimizer.optimized), self.layout.pipe_group)
        return set().union(*every)

    def _other_stages_keys(self) -> set:
        """The JAX keys that only other pipe stages hold (empty at one)."""
        if self.module.plan is None:
            return set()
        return set(self.module.whole_ckpt_keys().values()) - set(
            self.module.ckpt_keys().values())

    def _leaf_shard(self, state: bool):
        """The load's slice of each whole leaf by JAX key; None on one rank."""
        if self.layout is None:
            return None
        names = {key: name for name, key in self.module.ckpt_keys().items()}

        def shard(key: str, whole: torch.Tensor) -> torch.Tensor:
            name = names[key]
            t = self.module.shard_leaf(name, whole)
            return self.optimizer.piece(name, t) if state else t
        return shard

    def save_checkpoint(self, dir: Optional[Union[Path, str]] = None) -> Path:
        """Stage, manifest, fsync and rename onto ``global_step{N}``, then
        move ``latest``; with ``delete_past_optimizer_states`` the older
        checkpoints lose their optimizer files (and manifest entries) after
        that. With ``save_checkpoint_async`` this returns once every tensor
        has its host copy, and the writer thread does the rest in that
        order; ``finalize_checkpoints`` waits for it.

        Traced as ``trainer.save``; on the asynchronous path that covers
        the host copies and the submissions, and the writer thread's own
        ``ckpt.manifest`` / ``ckpt.rename`` / ``ckpt.latest`` spans carry
        the durable write."""
        with span("trainer.save", step=self.context.iterations):
            return self._save_checkpoint_inner(dir)

    def _save_checkpoint_inner(self, dir: Optional[Union[Path, str]] = None) -> Path:
        base = Path(dir or self.config.save_dir)
        if self.layout is not None:
            return self._save_sharded(base)
        base.mkdir(parents=True, exist_ok=True)
        writer = None
        if self.config.save_checkpoint_async:
            if self._ckpt_writer is None:
                self._ckpt_writer = AsyncCheckpointWriter()
            else:
                self._ckpt_writer.wait()  # never interleave two saves
            writer = self._ckpt_writer
        # after the writer's barrier: a new commit sweeps stale staging
        # directories, which must not race a previous save's finalize
        commit = CheckpointCommit(base, self.context.iterations)
        stage = commit.tmp_dir
        params = self._ckpt_params()
        with span("ckpt.stage", step=self.context.iterations,
                  backend="npz"):  # the only backend ported
            save_model_checkpoint(stage, params, recorder=commit.record, writer=writer)
            save_optimizer_checkpoint(stage, self.optimizer, self.module.ckpt_keys(),
                                      recorder=commit.record, writer=writer)
            self._write_stage_meta(stage, params)
        step_dir = commit.final_dir
        if writer is None:
            commit.finalize()
            self._commit_barrier_and_latest(commit)
        else:  # FIFO: committed, met and pointed to once every file is durable
            writer.submit(commit.finalize)
            writer.submit(self._commit_barrier_and_latest, commit)
        logger.info(f"saved checkpoint {step_dir}")
        if self.config.delete_past_optimizer_states:
            # after the commit: pruning first would leave no optimizer
            # state on disk if the process died in between
            if writer is None:
                self._prune_past_optimizer_states(base, step_dir)
            else:
                writer.submit(self._prune_past_optimizer_states, base, step_dir)
        self._last_saved_step = self.context.iterations
        return step_dir

    def _write_stage_meta(self, stage: Path, params: Dict[str, torch.Tensor]) -> None:
        """``MESH.json``, ``context.json`` and, with a config, ``config.yml``
        and ``vocab.json``: the architecture and tokenizer travel with the
        weights."""
        write_mesh_meta(stage, self._mesh_meta(params))
        self.context.save_checkpoint(stage)
        config = self._config_dict()
        if config is not None:
            (stage / "config.yml").write_text(yaml.safe_dump(config, sort_keys=False))
            vocab = self._vocab_file()
            if vocab is not None:
                shutil.copyfile(vocab, stage / "vocab.json")

    @torch.no_grad()
    def _save_sharded(self, base: Path) -> Path:
        """The save of a run of several ranks: every rank gathers each leaf
        with the others; global rank 0 writes, commits and moves ``latest``
        synchronously; then every rank meets at a barrier."""
        writing = self.layout.global_rank == 0
        step = self.context.iterations
        commit = stage = None
        if writing:
            base.mkdir(parents=True, exist_ok=True)
            commit = CheckpointCommit(base, step)
            stage = commit.tmp_dir
        params = self._ckpt_params()
        keys = self.module.whole_ckpt_keys()
        local = dict(self.module.model.named_parameters())
        everywhere = {key: local.get(name) for name, key in keys.items()}
        with span("ckpt.stage", step=step, backend="npz"):
            save_model_checkpoint(stage, everywhere, recorder=commit and commit.record,
                                  gather=self._leaf_gather(False))
            save_optimizer_checkpoint(stage, self.optimizer, keys,
                                      recorder=commit and commit.record,
                                      gather=self._leaf_gather(True))
        step_dir = base / f"global_step{step}"
        if writing:
            self._write_stage_meta(stage, params)
            commit.finalize()
            with span("ckpt.latest", step=step):  # the ranks meet at the barrier below
                commit.update_latest()
            step_dir = commit.final_dir
            logger.info(f"saved checkpoint {step_dir}")
            if self.config.delete_past_optimizer_states:
                self._prune_past_optimizer_states(base, step_dir)
        barrier()  # latest is durable before any rank goes on
        self._last_saved_step = step
        return step_dir

    @staticmethod
    def _prune_past_optimizer_states(base: Path, step_dir: Path) -> None:
        for old in sorted(base.glob("global_step*")):
            if old == step_dir:
                continue
            removed = [f.name for f in old.glob("optimizer_state_*")]
            for name in removed:
                (old / name).unlink()
            if removed:
                prune_manifest_entries(old, removed)

    def load_checkpoint(self, dir: Optional[Union[Path, str]] = None) -> bool:
        """Verified restore with fallback: the candidates in order, each
        verified against its manifest and then loaded; a corrupt one is
        skipped (an error with ``strict_checkpoint_load``). Returns whether
        a checkpoint was loaded."""
        base = Path(dir or self.config.load_dir)
        candidates = checkpoint_candidates(base)
        if not candidates:
            logger.warning(f"no checkpoint found at {base}")
            return False
        skipped: List[str] = []
        for step_dir in candidates:
            problems = verify_checkpoint(step_dir, deep=self.config.deep_checkpoint_verification)
            if problems:
                line = f"{step_dir.name}: {'; '.join(problems)}"
                if self.config.strict_checkpoint_load:
                    raise CheckpointCorruptionError(
                        f"checkpoint verification failed (strict mode): {line}")
                logger.warning(f"skipping invalid checkpoint {line}")
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
                logger.warning(f"skipping unreadable checkpoint {line}")
                skipped.append(line)
                continue
            if skipped:
                logger.warning(f"resumed from {step_dir.name} after skipping "
                                    f"{len(skipped)} checkpoint(s): " + " | ".join(skipped))
            return True
        logger.warning(f"no valid checkpoint under {base}; skipped: " + " | ".join(skipped))
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
            logger.warning(f"config changed since {step_dir.name} was saved; expected "
                                "for finetunes/topology changes, suspicious for a plain resume")

    def _load_step_dir(self, step_dir: Path) -> None:
        c = self.config
        self._warn_if_config_changed(step_dir)
        params = self._ckpt_params()
        # a checkpoint another topology saved loads as it is (global arrays
        # per layer); one whose global shapes disagree is another model
        plan = reshard_plan(read_mesh_meta(step_dir), self._current_topology_dict(),
                            self._param_records(params))
        if plan is not None:
            fire_reshard_point(step_dir, plan)
            manifest = read_manifest(step_dir)
            logger.log_event("ckpt-reshard",
                                  step=None if manifest is None else manifest.get("step"),
                                  **plan.event_fields())
        self.restored_model_keys = set()
        load_model_checkpoint(step_dir, params,
                              allowed_missing_keys=c.allowed_missing_keys_in_checkpoint,
                              allowed_unexpected_keys=c.allowed_unexpected_keys_in_checkpoint,
                              ignore_keys=c.ignore_keys_in_checkpoint,
                              restored_keys=self.restored_model_keys,
                              shard=self._leaf_shard(False),
                              other_stages=self._other_stages_keys())
        if c.merge_lora_after_loading_checkpoint:
            self.module.merge_lora_weights()
            logger.info("merged LoRA deltas into base weights after load")
        self.optimizer_states_loaded = False
        # merged, the checkpoint's f32 masters would bring the unmerged
        # weights and the LoRA's B back with the first step
        if c.load_optimizer_states and not c.merge_lora_after_loading_checkpoint:
            try:
                load_optimizer_checkpoint(step_dir, self.optimizer, self.module.ckpt_keys(),
                                          shard=self._leaf_shard(True))
                self.optimizer_states_loaded = True
            except FileNotFoundError:
                logger.warning(f"optimizer states absent in {step_dir}")
        if not self.optimizer_states_loaded:
            # the masters were copied from the random init: take them from
            # the loaded parameters, or the first step would revert the model
            self.optimizer.state = self.optimizer.init_state()
        if c.load_context:
            self.context.load_checkpoint(step_dir)
            # the cursors count global samples: the same numbers resume the
            # stream when this run's batch grid divides them
            mbs, dp = self.topology.micro_batch_size, self.topology.data_parallel_size
            ctx = self.context
            ctx.consumed_samples = rescale_consumed_samples(
                ctx.consumed_samples, micro_batch_size=mbs, data_parallel_size=dp)
            ctx.consumed_eval_samples = rescale_consumed_samples(
                ctx.consumed_eval_samples, micro_batch_size=mbs, data_parallel_size=dp,
                what="consumed_eval_samples", on_misaligned="floor")
        logger.info(f"loaded checkpoint {step_dir}")


def _maybe(cast: Callable, v: Any) -> Any:
    return None if v is None else cast(v)
