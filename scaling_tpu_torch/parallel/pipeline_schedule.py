"""The pipeline schedules' instruction DSL and their simulator (the port's
copy of scaling_tpu/parallel/pipeline_schedule.py; pure Python, no
devices).

Each schedule gives one pipe rank's instruction stream for a step:
``PipelineScheduleTrain`` (1F1B: warm-up forwards, then one forward and
one backward in turn, then the cool-down backwards),
``PipelineScheduleInterleaved`` (virtual stages: micro-batches in groups
of ``pp`` circulate ``virtual_size`` rounds through the stage ring, every
forward work item first, then their backwards in reverse),
``PipelineScheduleFillDrain`` (its ``virtual_size`` 1 degenerate),
``PipelineScheduleTokenSlice`` and ``PipelineScheduleInference``. The
port's executor (``parallel.pipeline_engine``) runs the streams of
``executor_schedule`` as they stand: 1F1B without virtual stages or token
slices, the interleaved stream with virtual stages, and the token-slice
stream with ``pipe_token_slices`` (every (micro-batch, slice) forward in
m-major order, then their backwards in reverse, each transfer tagged with
its slice).

``SimulationEngine`` replays the streams with instruction durations into
per-rank timelines (sends post and go on, a receive waits for its send):
the tuner prices pipeline bubbles with it (``simulate_layout``),
``durations_from_profile`` calibrates it from a run directory's spans
(``_durations_from_run_dir``, which ``obs report`` shares its span
aggregation with), and ``illustrate`` draws its timeline as text.
``visualize`` draws it with matplotlib, which the card's machine lacks:
it raises NotImplementedError by name.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional


# ------------------------------------------------------------- instructions
class Instruction(NamedTuple):
    name: str
    micro_batch_id: Optional[int] = None
    buffer_id: Optional[int] = None
    # explicit comm peer (interleaved wrap: stage pp-1 sends to stage 0);
    # None keeps the classic linear neighbour convention
    peer: Optional[int] = None
    # disambiguates repeated crossings of the same (kind, micro_batch)
    # between the same rank pair (a chunk/round id); None for the classic
    # schedules, whose crossings are unique
    tag: Optional[int] = None


def InstructionLoadMicroBatch(micro_batch_id, buffer_id):
    return Instruction("load_micro_batch", micro_batch_id, buffer_id)


def InstructionRecvActivation(micro_batch_id, buffer_id, peer=None, tag=None):
    return Instruction("recv_activation", micro_batch_id, buffer_id, peer, tag)


def InstructionSendActivation(micro_batch_id, buffer_id, peer=None, tag=None):
    return Instruction("send_activation", micro_batch_id, buffer_id, peer, tag)


def InstructionForwardPass(micro_batch_id, buffer_id):
    return Instruction("forward_pass", micro_batch_id, buffer_id)


def InstructionLoss(micro_batch_id, buffer_id):
    return Instruction("loss", micro_batch_id, buffer_id)


def InstructionBackwardPass(micro_batch_id, buffer_id):
    return Instruction("backward_pass", micro_batch_id, buffer_id)


def InstructionSendGrad(micro_batch_id, buffer_id, peer=None, tag=None):
    return Instruction("send_grad", micro_batch_id, buffer_id, peer, tag)


def InstructionRecvGrad(micro_batch_id, buffer_id, peer=None, tag=None):
    return Instruction("recv_grad", micro_batch_id, buffer_id, peer, tag)


def InstructionReduceTiedGrads():
    return Instruction("reduce_tied_grads")


def InstructionOptimizerStep():
    return Instruction("optimizer_step")


def InstructionStoreMicroBatch(micro_batch_id, buffer_id):
    return Instruction("store_micro_batch", micro_batch_id, buffer_id)


# ---------------------------------------------------------------- schedules
@dataclass
class PipelineScheduleBase:
    pipe_parallel_size: int
    pipe_parallel_rank: int
    gradient_accumulation_steps: int

    @property
    def num_buffers(self) -> int:
        return max(
            2,
            min(
                self.pipe_parallel_size - self.pipe_parallel_rank + 1,
                self.gradient_accumulation_steps,
            ),
        )

    def buffer_for(self, micro_batch_id: int) -> int:
        return micro_batch_id % self.num_buffers

    def duration_scale(self, name: str) -> float:
        """Per-instruction duration multiplier: schedules whose work items
        are fractions of a micro-batch (virtual-stage chunks, token
        slices) scale their compute (and, where the payload shrinks,
        comm) below the profile's full-micro-batch durations."""
        return 1.0

    def instructions(self) -> List[Instruction]:
        raise NotImplementedError


class PipelineScheduleTrain(PipelineScheduleBase):
    """1F1B: warmup forwards, steady 1F1B interleave, cooldown backwards.

    Per-rank step count is ``2 * (grad_accum + pp - 1)`` (reference:
    train.py:41-43); each step slot is a forward or backward opportunity
    offset by the rank so neighbouring ranks interleave.
    """

    def instructions(self) -> List[Instruction]:
        pp = self.pipe_parallel_size
        rank = self.pipe_parallel_rank
        gas = self.gradient_accumulation_steps
        is_first = rank == 0
        is_last = rank == pp - 1

        # number of warmup forwards before the 1F1B steady state
        warmup = min(pp - rank - 1, gas)
        instructions: List[Instruction] = []
        fwd_id = 0
        bwd_id = 0

        def forward(mb: int):
            buf = self.buffer_for(mb)
            if is_first:
                instructions.append(InstructionLoadMicroBatch(mb, buf))
            else:
                instructions.append(InstructionRecvActivation(mb, buf))
            instructions.append(InstructionForwardPass(mb, buf))
            if is_last:
                instructions.append(InstructionLoss(mb, buf))
            else:
                instructions.append(InstructionSendActivation(mb, buf))

        def backward(mb: int):
            buf = self.buffer_for(mb)
            if not is_last:
                instructions.append(InstructionRecvGrad(mb, buf))
            instructions.append(InstructionBackwardPass(mb, buf))
            if not is_first:
                instructions.append(InstructionSendGrad(mb, buf))

        for _ in range(warmup):
            forward(fwd_id)
            fwd_id += 1
        while fwd_id < gas:
            forward(fwd_id)
            fwd_id += 1
            backward(bwd_id)
            bwd_id += 1
        while bwd_id < gas:
            backward(bwd_id)
            bwd_id += 1

        instructions.append(InstructionReduceTiedGrads())
        instructions.append(InstructionOptimizerStep())
        return instructions


class PipelineScheduleInference(PipelineScheduleBase):
    """Forward-only, alternating two buffers (reference: inference.py:16-75)."""

    def instructions(self) -> List[Instruction]:
        pp = self.pipe_parallel_size
        rank = self.pipe_parallel_rank
        gas = self.gradient_accumulation_steps
        instructions: List[Instruction] = []
        for mb in range(gas):
            buf = mb % 2
            if rank == 0:
                instructions.append(InstructionLoadMicroBatch(mb, buf))
            else:
                instructions.append(InstructionRecvActivation(mb, buf))
            instructions.append(InstructionForwardPass(mb, buf))
            if rank == pp - 1:
                instructions.append(InstructionStoreMicroBatch(mb, buf))
            else:
                instructions.append(InstructionSendActivation(mb, buf))
        return instructions


def _interleaved_work_items(gas: int, pp: int, virtual_size: int):
    """Injection order of the spatial interleaved executor
    (pipeline.py): micro-batches in groups of pp, each group cycling
    ``virtual_size`` rounds through the stage ring before the next group
    starts."""
    items = []
    for g0 in range(0, gas, pp):
        group = range(g0, min(g0 + pp, gas))
        for rnd in range(virtual_size):
            for m in group:
                items.append((m, rnd))
    return items


@dataclass
class PipelineScheduleInterleaved(PipelineScheduleBase):
    """Spatial interleaved virtual stages (Megatron-LM, arxiv
    2104.04473; the JAX package's executor:
    ``scaling_tpu/parallel/pipeline.py`` ``PipelinedBody._interleaved``).

    Each rank runs one ``1/virtual_size``-thick layer chunk per work
    item; stage pp-1's output wraps back to stage 0 between rounds (the
    explicit ``peer`` on the comm instructions). Forward streams all
    work items, backward mirrors them in reverse — autodiff through
    the tick scan, not 1F1B. At ``virtual_size=1`` this degenerates to
    the naive spatial fill-drain schedule and is the bubble baseline the
    interleaved/token-slice variants are judged against."""

    virtual_size: int = 2

    def duration_scale(self, name: str) -> float:
        # chunks carry the full micro-batch's activations (comm unscaled,
        # and v x more of it) but 1/v of its layers (compute scaled)
        if name in ("forward_pass", "backward_pass"):
            return 1.0 / self.virtual_size
        return 1.0

    def instructions(self) -> List[Instruction]:
        pp = self.pipe_parallel_size
        r = self.pipe_parallel_rank
        gas = self.gradient_accumulation_steps
        v = self.virtual_size
        items = _interleaved_work_items(gas, pp, v)
        ins: List[Instruction] = []
        # each forward edge is tagged by its receiving chunk id
        # (rnd*pp + rank), unique per crossing — at pp=2 the linear hop and
        # the wrap cross the SAME rank pair, and an untagged match would
        # pair a send with the wrong round's recv
        for m, rnd in items:
            buf = self.buffer_for(m)
            chunk = rnd * pp + r
            if r == 0 and rnd == 0:
                ins.append(InstructionLoadMicroBatch(m, buf))
            else:
                ins.append(InstructionRecvActivation(
                    m, buf, peer=(pp - 1 if r == 0 else r - 1), tag=chunk))
            ins.append(InstructionForwardPass(m, buf))
            if r == pp - 1 and rnd == v - 1:
                ins.append(InstructionLoss(m, buf))
            else:
                ins.append(InstructionSendActivation(
                    m, buf, peer=(0 if r == pp - 1 else r + 1), tag=chunk + 1))
        for m, rnd in reversed(items):
            buf = self.buffer_for(m)
            chunk = rnd * pp + r
            if not (r == pp - 1 and rnd == v - 1):
                ins.append(InstructionRecvGrad(
                    m, buf, peer=(0 if r == pp - 1 else r + 1), tag=chunk + 1))
            ins.append(InstructionBackwardPass(m, buf))
            if not (r == 0 and rnd == 0):
                ins.append(InstructionSendGrad(
                    m, buf, peer=(pp - 1 if r == 0 else r - 1), tag=chunk))
        ins.append(InstructionReduceTiedGrads())
        ins.append(InstructionOptimizerStep())
        return ins


@dataclass
class PipelineScheduleFillDrain(PipelineScheduleInterleaved):
    """Naive spatial fill-drain (GPipe): the ``virtual_size=1``
    degenerate of the interleaved schedule — the baseline the simulator
    compares bubble fractions against."""

    virtual_size: int = 1


@dataclass
class PipelineScheduleTokenSlice(PipelineScheduleBase):
    """TeraPipe token slicing (arxiv 2102.07988; executor:
    ``PipelinedBody._token_sliced``): each micro-batch splits into
    ``token_slices`` causal sequence chunks pipelined as independent
    work items (m-major order keeps a micro-batch's chunks causal at
    every stage). First-order cost model: compute AND comm scale 1/S
    (the payload is 1/S of the sequence; the attention prefix term is
    folded into the same scale)."""

    token_slices: int = 2

    _SCALED = (
        "forward_pass", "backward_pass", "loss", "load_micro_batch",
        "store_micro_batch", "send_activation", "recv_activation",
        "send_grad", "recv_grad",
    )

    def duration_scale(self, name: str) -> float:
        return 1.0 / self.token_slices if name in self._SCALED else 1.0

    def instructions(self) -> List[Instruction]:
        pp = self.pipe_parallel_size
        r = self.pipe_parallel_rank
        gas = self.gradient_accumulation_steps
        S = self.token_slices
        items = [(m, k) for m in range(gas) for k in range(S)]
        ins: List[Instruction] = []
        for m, k in items:
            buf = self.buffer_for(m)
            if r == 0:
                ins.append(InstructionLoadMicroBatch(m, buf))
            else:
                ins.append(InstructionRecvActivation(m, buf, peer=r - 1, tag=k))
            ins.append(InstructionForwardPass(m, buf))
            if r == pp - 1:
                ins.append(InstructionLoss(m, buf))
            else:
                ins.append(InstructionSendActivation(m, buf, peer=r + 1, tag=k))
        for m, k in reversed(items):
            buf = self.buffer_for(m)
            if r != pp - 1:
                ins.append(InstructionRecvGrad(m, buf, peer=r + 1, tag=k))
            ins.append(InstructionBackwardPass(m, buf))
            if r != 0:
                ins.append(InstructionSendGrad(m, buf, peer=r - 1, tag=k))
        ins.append(InstructionReduceTiedGrads())
        ins.append(InstructionOptimizerStep())
        return ins


# ----------------------------------------------------------------- simulator
@dataclass
class SimulationEngine:
    """Replays a profile (instruction durations) into per-rank timelines.

    ``durations``: {instruction_name: seconds}, optionally overridden per
    (name, rank). Communication instructions synchronise sender/receiver.
    Produces total time and per-rank idle fraction — the reference renders
    this as a PNG timeline; here the data structure is returned for tooling.
    (reference: pipeline_schedule/base.py:276-595)
    """

    pipe_parallel_size: int
    gradient_accumulation_steps: int
    durations: Dict[str, float] = field(default_factory=dict)

    DEFAULTS = {
        "load_micro_batch": 0.1,
        "recv_activation": 0.1,
        "send_activation": 0.1,
        "forward_pass": 1.0,
        "loss": 0.1,
        "backward_pass": 2.0,
        "send_grad": 0.1,
        "recv_grad": 0.1,
        "reduce_tied_grads": 0.2,
        "optimizer_step": 0.5,
        "store_micro_batch": 0.1,
    }

    def duration(self, name: str) -> float:
        return self.durations.get(name, self.DEFAULTS.get(name, 0.0))

    def simulate(self, schedule_cls=PipelineScheduleTrain) -> dict:
        pp = self.pipe_parallel_size
        scheds = [
            schedule_cls(
                pipe_parallel_size=pp,
                pipe_parallel_rank=r,
                gradient_accumulation_steps=self.gradient_accumulation_steps,
            )
            for r in range(pp)
        ]
        schedules = [s.instructions() for s in scheds]
        cursors = [0] * pp
        times = [0.0] * pp
        busy = [0.0] * pp
        timeline: List[dict] = []
        # comm matching: sends/recvs of (kind, mb[, tag]) pair between
        # peers — the tag separates repeated crossings of the same pair
        # (interleaved rounds at pp=2 wrap over the same two ranks)
        pending: Dict[tuple, float] = {}

        def comm_peer(name: str, rank: int) -> Optional[int]:
            if name in ("send_activation", "recv_grad"):
                return rank + 1
            if name in ("recv_activation", "send_grad"):
                return rank - 1
            return None

        def dur(rank: int, name: str) -> float:
            return self.duration(name) * scheds[rank].duration_scale(name)

        progressed = True
        while progressed:
            progressed = False
            for r in range(pp):
                while cursors[r] < len(schedules[r]):
                    ins = schedules[r][cursors[r]]
                    peer = (
                        ins.peer if ins.peer is not None
                        else comm_peer(ins.name, r)
                    )
                    if peer is None:
                        start = times[r]
                        end = start + dur(r, ins.name)
                        timeline.append(
                            {"rank": r, "name": ins.name, "micro_batch": ins.micro_batch_id,
                             "start": start, "end": end}
                        )
                        busy[r] += end - start
                        times[r] = end
                        cursors[r] += 1
                        progressed = True
                        continue
                    mb = ins.micro_batch_id
                    kind = "act" if "activation" in ins.name else "grad"
                    lo, hi = min(r, peer), max(r, peer)
                    key = (kind, mb, ins.tag, lo, hi)
                    if ins.name.startswith("send"):
                        # sends are async: post completion time and continue
                        end = times[r] + dur(r, ins.name)
                        pending[key] = end
                        busy[r] += dur(r, ins.name)
                        timeline.append(
                            {"rank": r, "name": ins.name, "micro_batch": mb,
                             "start": times[r], "end": end}
                        )
                        times[r] = end
                        cursors[r] += 1
                        progressed = True
                        continue
                    # recvs BLOCK until the matching send has completed —
                    # this is what creates the pipeline bubble the simulator
                    # exists to predict
                    if key in pending:
                        data_ready = pending.pop(key)
                        start = max(times[r], data_ready)
                        end = start + dur(r, ins.name)
                        busy[r] += dur(r, ins.name)
                        times[r] = end
                        timeline.append(
                            {"rank": r, "name": ins.name, "micro_batch": mb,
                             "start": start, "end": end}
                        )
                        cursors[r] += 1
                        progressed = True
                        continue
                    break  # blocked on an unposted send; retry next sweep
        total = max(times)
        deadlocked = any(cursors[r] < len(schedules[r]) for r in range(pp))
        idle = [1.0 - (b / total if total else 0.0) for b in busy]
        return {
            "total_time": total,
            "idle_fraction": idle,
            "timeline": timeline,
            "deadlocked": deadlocked,
        }


def schedule_class_for(virtual_size: int = 1, token_slices: int = 1):
    """The spatial executor's schedule for a layout's knobs: interleaved
    virtual stages, TeraPipe token slices, or the fill-drain baseline.
    Returns a factory ``SimulationEngine.simulate`` accepts."""
    import functools

    if virtual_size > 1 and token_slices > 1:
        raise ValueError("virtual stages and token slices are mutually "
                         "exclusive (TopologyConfig enforces this)")
    if virtual_size > 1:
        return functools.partial(
            PipelineScheduleInterleaved, virtual_size=virtual_size
        )
    if token_slices > 1:
        return functools.partial(
            PipelineScheduleTokenSlice, token_slices=token_slices
        )
    return PipelineScheduleFillDrain


def executor_schedule(pipe_parallel_size: int, pipe_parallel_rank: int,
                      gradient_accumulation_steps: int,
                      virtual_size: int = 1, token_slices: int = 1) -> PipelineScheduleBase:
    """The schedule the port's executor runs on a rank: 1F1B
    (``PipelineScheduleTrain``) without virtual stages or token slices, the
    interleaved stream with virtual stages, the token-slice stream with
    token slices."""
    if virtual_size > 1 and token_slices > 1:
        raise ValueError("virtual stages and token slices are mutually exclusive")
    if token_slices > 1:
        return PipelineScheduleTokenSlice(pipe_parallel_size, pipe_parallel_rank,
                                          gradient_accumulation_steps,
                                          token_slices=token_slices)
    if virtual_size > 1:
        return PipelineScheduleInterleaved(pipe_parallel_size, pipe_parallel_rank,
                                           gradient_accumulation_steps, virtual_size)
    return PipelineScheduleTrain(pipe_parallel_size, pipe_parallel_rank,
                                 gradient_accumulation_steps)


def work_items(gradient_accumulation_steps: int, pipe_parallel_size: int,
               virtual_size: int = 1, token_slices: int = 1) -> List[tuple]:
    """The (micro-batch, round) of each forward of ``executor_schedule``'s
    stream, in order, or under token slices its (micro-batch, slice); the
    backwards take them in reverse under virtual stages and token slices,
    in order under 1F1B."""
    if token_slices > 1:
        return [(m, k) for m in range(gradient_accumulation_steps) for k in range(token_slices)]
    if virtual_size > 1:
        return _interleaved_work_items(gradient_accumulation_steps, pipe_parallel_size,
                                       virtual_size)
    return [(m, 0) for m in range(gradient_accumulation_steps)]


def simulate_layout(
    pipe_parallel_size: int,
    gradient_accumulation_steps: int,
    durations: Optional[Dict[str, float]] = None,
    virtual_size: int = 1,
    token_slices: int = 1,
) -> dict:
    """One layout's schedule replayed through the simulator — the surface
    the auto-sharding tuner (``scaling_tpu_torch.tune``, docs/TUNING.md) prices
    pipeline bubbles with. Returns the engine's result plus the schedule
    label and the mean idle fraction as ``bubble_fraction``."""
    if virtual_size > 1:
        label = f"interleaved(v={virtual_size})"
    elif token_slices > 1:
        label = f"token-slice(S={token_slices})"
    else:
        label = "fill-drain"
    engine = SimulationEngine(
        pipe_parallel_size=pipe_parallel_size,
        gradient_accumulation_steps=gradient_accumulation_steps,
        durations=durations or {},
    )
    result = engine.simulate(schedule_class_for(virtual_size, token_slices))
    if result["deadlocked"]:
        raise RuntimeError(
            f"schedule {label} (pp={pipe_parallel_size}, "
            f"gas={gradient_accumulation_steps}) deadlocked in simulation; "
            "a layout the tuner prices must replay cleanly"
        )
    result["schedule"] = label
    idle = result["idle_fraction"]
    result["bubble_fraction"] = sum(idle) / len(idle) if idle else 0.0
    return result


def durations_from_profile(
    observations: Optional[list],
    gradient_accumulation_steps: int,
    run_dir=None,
) -> Dict[str, float]:
    """Simulator instruction durations from a real measurement: from a run
    directory's ``step.fwdbwd`` / ``step.sync`` / ``step.data`` spans
    (``_durations_from_run_dir``) where it has them, else the profile's
    mean ``step_time`` split with JAX's 3.2 factor (forward 1, backward 2,
    the rest small multiples of the unit)."""
    gas = gradient_accumulation_steps
    if run_dir is not None:
        calibrated = _durations_from_run_dir(run_dir, gas)
        if calibrated is not None:
            return calibrated
    steps = [o["step_time"] for o in (observations or []) if "step_time" in o]
    if not steps:
        raise ValueError("profile has no step_time observations")
    unit = sum(steps) / len(steps) / (gas * 3.2)
    return _unit_durations(unit, 0.05 * unit)


def _unit_durations(unit: float, load: float) -> Dict[str, float]:
    return {
        "forward_pass": unit,
        "backward_pass": 2.0 * unit,
        "loss": 0.1 * unit,
        "optimizer_step": 0.1 * unit,
        "load_micro_batch": load,
        "store_micro_batch": 0.05 * unit,
        "recv_activation": 0.05 * unit,
        "send_activation": 0.05 * unit,
        "send_grad": 0.05 * unit,
        "recv_grad": 0.05 * unit,
    }


def _durations_from_run_dir(run_dir, gas: int) -> Optional[Dict[str, float]]:
    """Span-calibrated instruction durations, or None when the run dir has
    no ``step.fwdbwd`` spans: the median per-step compute (dispatch and
    drain, amortised as the obs report does, ``step_span_sums``) split as
    forward 1 and backward 2 per micro-batch, the load from the median
    ``step.data`` span."""
    from ..obs.report import load_run_dir, step_compute_samples, step_span_sums

    data = load_run_dir(run_dir)
    by_host = step_span_sums(data.spans, ("step.fwdbwd", "step.sync", "step.data"))
    recs = [rec for steps in by_host.values() for rec in steps.values()
            if "step.fwdbwd" in rec]
    if not recs:
        return None
    compute = sorted(step_compute_samples(
        step_span_sums(data.spans, ("step.fwdbwd", "step.sync"))))
    unit = compute[len(compute) // 2] / (gas * 3.0)
    datas = sorted(r["step.data"] for r in recs if "step.data" in r)
    return _unit_durations(unit, datas[len(datas) // 2] / gas if datas else 0.05 * unit)


def illustrate(
    pipe_parallel_size: int,
    gradient_accumulation_steps: int,
    schedule_cls=PipelineScheduleTrain,
    width: int = 100,
    durations: Optional[Dict[str, float]] = None,
) -> str:
    """An ASCII timeline of a simulated schedule: one row per pipe rank of
    F/B/L/O/d/s cells, then the total and each rank's idle share; a
    deadlocked replay is framed by a banner."""
    result = SimulationEngine(pipe_parallel_size=pipe_parallel_size,
                              gradient_accumulation_steps=gradient_accumulation_steps,
                              durations=durations or {}).simulate(schedule_cls)
    total = result["total_time"] or 1.0
    rows = [[" "] * width for _ in range(pipe_parallel_size)]
    glyphs = {"forward_pass": "F", "backward_pass": "B", "optimizer_step": "O",
              "loss": "L", "load_micro_batch": "d", "store_micro_batch": "s"}
    for ev in result["timeline"]:
        g = glyphs.get(ev["name"])
        if g is None:
            continue
        lo = int(ev["start"] / total * (width - 1))
        hi = max(lo + 1, int(ev["end"] / total * (width - 1)))
        for c in range(lo, min(hi, width)):
            rows[ev["rank"]][c] = g
    lines = [f"rank {r}: |{''.join(row)}|" for r, row in enumerate(rows)]
    idle = ", ".join(f"{i:.0%}" for i in result["idle_fraction"])
    lines.append(f"total {result['total_time']:.2f}s  idle per rank: {idle}")
    if result["deadlocked"]:
        banner = ("!! DEADLOCK: schedule never completed — unmatched sends/recvs; "
                  "the timeline above is PARTIAL and its idle numbers meaningless")
        lines.insert(0, banner)
        lines.append(banner)
    return "\n".join(lines)


def visualize(*args, **kwargs) -> None:
    """JAX's PNG Gantt timeline needs matplotlib, which the port's
    machines lack: refused by name (``illustrate`` draws the same timeline
    as text)."""
    raise NotImplementedError("pipeline_schedule.visualize (a matplotlib PNG) is not ported; "
                              "illustrate() draws the timeline as text")
