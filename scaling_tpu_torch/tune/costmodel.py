"""Topology-aware comm/compute cost model for layout search
(counterpart of ``scaling_tpu/tune/costmodel.py``).

The TASP/ATP result (arxiv 2509.26541, 2301.08658) this module encodes:
layout choice is dominated by WHERE each mesh axis's collectives run —
an axis folded inside an NVLink domain moves bytes an order of magnitude
faster than one that crosses the hosts' network — so a placement engine
needs (a) per-axis traffic volumes and (b) a link-class map, not a single
"communication" scalar.

Ingredients:

- **analytic volumes**: closed-form per-axis estimates — data-axis
  gradient all-reduce, model-axis activation reductions, pipe-edge
  collective-permutes, ring/ulysses context traffic, ZeRO-3 parameter
  all-gathers — the textbook forms Megatron-LM/ATP use;
- **calibration**: a compute-efficiency scalar taken from a real
  measurement (an obs run dir's MFU, or a measured MFU handed in) so
  predicted step times live in measured units, and the obs report's
  tuner section can score the prediction against span-measured step time
  per run.

The generation table describes the card: an H100 SXM's dense bf16 peak
and its NVLink rate inside a domain, the host NIC across domains.
Pipeline layouts are priced through the port's schedule simulator
(``parallel.pipeline_schedule.simulate_layout``, the copy of the JAX
package's that the pipeline executor runs the streams of): bubble
fractions come from replaying the actual schedule (fill-drain /
interleaved / token-slice). The scoring of a hand-built layout of more
devices is the JAX tuner's math, unchanged.
"""

from __future__ import annotations

import dataclasses
import math
import re
from pathlib import Path
from typing import Dict, List, Optional

from .layouts import Layout, ModelSpec

BF16 = 2  # activation / parameter bytes
F32 = 4   # gradient / master bytes

# Token slicing forces attention through the segment-aware KV-cache path
# — the flash kernel does not run there. Two factors price that:
#
# - CACHE_VS_DENSE(S): FLOPs ratio of the S-sliced cache path against one
#   full-sequence DENSE (unfused) attention: the sliced path computes
#   sum_k (s/S * k*s/S) scores = (S+1)/(2S) of the dense s^2.
# - FLASH_CAUSAL_SKIP: the flash kernel's causal block skip does ~s^2/2
#   effective work, so relative to the FLASH baseline the sliced path
#   pays 2 * CACHE_VS_DENSE(S) = (S+1)/S.
# - CACHE_PATH_OVERHEAD: non-FLOPs cost of the cache path (per-slice
#   cache concatenation/bookkeeping, no fused softmax) — modest constant.
FLASH_CAUSAL_SKIP = 2.0
CACHE_PATH_OVERHEAD = 1.1


def cache_vs_dense_flops_ratio(token_slices: int) -> float:
    s = token_slices
    return (s + 1) / (2.0 * s)


def token_slice_attention_factor(token_slices: int) -> float:
    """Multiplier on the attention FLOPs share when the sequence is split
    into ``token_slices`` causal cache-path chunks, relative to the
    flash-kernel baseline every other layout runs."""
    if token_slices <= 1:
        return 1.0
    return (
        FLASH_CAUSAL_SKIP
        * cache_vs_dense_flops_ratio(token_slices)
        * CACHE_PATH_OVERHEAD
    )


# ------------------------------------------------------------ link classes
@dataclasses.dataclass(frozen=True)
class LinkClass:
    name: str          # "nvlink" | "nic"
    gbytes_per_s: float
    latency_s: float


# The card's figures, from the NVIDIA H100 SXM5 80GB data sheet (700 W
# board power): NVLink 4 at 900 GB/s per GPU (bidirectional, the in-domain
# link), dense bf16 989.4 TFLOP/s. Across domains traffic rides the hosts'
# NICs: one 400 Gb/s ConnectX-7 per GPU in a DGX H100, 50 GB/s. Absolute
# numbers matter less than the in:cross ratio for ranking; the
# calibration loop owns absolute scale. name -> (in-domain GB/s, peak
# TFLOP/s).
_GENERATIONS = {
    "h100_sxm": (900.0, 989.4),
}


@dataclasses.dataclass(frozen=True)
class SliceTopology:
    """What the tuner knows about the devices: how many, how many of
    them share an NVLink domain (contiguous in mesh order), and the
    generation's link rates. ``nvlink_domain == chips`` is one domain
    (everything on NVLink); smaller domains model crossings of the hosts'
    network. The latencies are order-of-magnitude small-message figures
    (NCCL over NVLink, over InfiniBand), not measured by the port."""

    chips: int
    nvlink_domain: Optional[int] = None  # None: one domain, all NVLink
    generation: str = "h100_sxm"
    nic_gbytes_per_s: float = 50.0
    nvlink_latency_s: float = 3e-6
    nic_latency_s: float = 10e-6

    @property
    def domain(self) -> int:
        return self.nvlink_domain or self.chips

    @property
    def peak_tflops(self) -> float:
        return _GENERATIONS[self.generation][1]

    @property
    def nvlink(self) -> LinkClass:
        return LinkClass(
            "nvlink", _GENERATIONS[self.generation][0], self.nvlink_latency_s
        )

    @property
    def nic(self) -> LinkClass:
        return LinkClass("nic", self.nic_gbytes_per_s, self.nic_latency_s)

    def to_dict(self) -> dict:
        return {
            "chips": self.chips, "nvlink_domain": self.domain,
            "generation": self.generation,
            "nvlink_gbytes_per_s": self.nvlink.gbytes_per_s,
            "nic_gbytes_per_s": self.nic.gbytes_per_s,
        }


# mesh order (topology/topology.py MESH_AXES): flat rank =
# (((pipe*dp + data)*cp + context)*mp + model)
_AXES = ("pipe", "data", "context", "model")


def axis_sizes(layout: Layout) -> Dict[str, int]:
    return {
        "pipe": layout.pp, "data": layout.dp,
        "context": layout.cp, "model": layout.mp,
    }


def axis_stride(layout: Layout, axis: str) -> int:
    strides = {
        "model": 1,
        "context": layout.mp,
        "data": layout.cp * layout.mp,
        "pipe": layout.dp * layout.cp * layout.mp,
    }
    return strides[axis]


def link_for_axis(layout: Layout, topo: SliceTopology, axis: str) -> LinkClass:
    """NVLink when every communicating group of this axis fits inside one
    NVLink domain of contiguous device ids, the NIC as soon as any
    neighbour pair crosses a domain boundary. Fused axes ("data+model")
    take the worst member — one NIC hop prices the whole group."""
    if "+" in axis:
        links = [link_for_axis(layout, topo, a) for a in axis.split("+")]
        return min(links, key=lambda l: l.gbytes_per_s)
    if axis not in _AXES:
        return topo.nvlink  # "world"/"unattributed": assume in-domain
    stride = axis_stride(layout, axis)
    size = axis_sizes(layout)[axis]
    # groups are arithmetic sequences {base + k*stride} spanning an
    # aligned block of stride*size contiguous ids; every group stays
    # inside one domain iff that block size DIVIDES the domain — a
    # merely-smaller block can straddle a boundary (stride=1, size=2,
    # domain=3: group {2,3} crosses), so non-dividing shapes price the
    # NIC (conservative, and exact for power-of-two domains)
    block = stride * size
    return (
        topo.nvlink if block <= topo.domain and topo.domain % block == 0
        else topo.nic
    )


# --------------------------------------------------------- collective math
_RING_FACTOR = {
    # effective wire bytes per payload byte on a size-n ring
    "all-reduce": lambda n: 2.0 * (n - 1) / n,
    "all-gather": lambda n: (n - 1) / n,
    "reduce-scatter": lambda n: (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}


def collective_seconds(op: str, payload_bytes: float, count: int,
                       axis_size: int, link: LinkClass) -> float:
    if axis_size <= 1 or payload_bytes <= 0:
        return count * link.latency_s if count else 0.0
    factor = _RING_FACTOR.get(op, lambda n: 1.0)(axis_size)
    return payload_bytes * factor / (link.gbytes_per_s * 1e9) + (
        count * link.latency_s
    )


def analytic_collectives(model: ModelSpec, layout: Layout) -> List[dict]:
    """Per-(op, axis) payload estimate for one optimizer step, in the
    JAX audit's collective-inventory record shape ({op, axis, count,
    bytes}) — bytes are per-device payload per step."""
    L = layout
    recs: List[dict] = []
    act = L.micro_batch_size * (model.sequence_length // L.cp) * (
        model.hidden_size
    ) * BF16  # one micro-batch's boundary activations per device
    params_shard = model.parameter_count // (L.pp * L.mp)
    gas = L.gradient_accumulation_steps
    layers_local = max(1, model.num_layers // L.pp)

    if L.dp > 1:
        if L.zero_stage >= 3:
            # FSDP: reduce-scatter grads once; re-gather bf16 params for
            # forward and backward
            recs.append({"op": "reduce-scatter", "axis": "data", "count": 1,
                         "bytes": params_shard * F32})
            recs.append({"op": "all-gather", "axis": "data", "count": 2,
                         "bytes": 2 * params_shard * BF16})
        else:
            recs.append({"op": "all-reduce", "axis": "data", "count": 1,
                         "bytes": params_shard * F32})
    if L.mp > 1:
        # Megatron TP: 2 activation reductions per layer forward + 2
        # backward, per micro-batch (SP recasts them as RS+AG at equal
        # volume, so sp does not change the estimate)
        count = 4 * layers_local * gas
        recs.append({"op": "all-reduce", "axis": "model", "count": count,
                     "bytes": count * act})
    if L.pp > 1:
        # stage-boundary shift each tick, forward + backward; interleaved
        # circulates v rounds (v x the crossings at full payload), token
        # slices cross S x at payload/S (equal volume)
        crossings = 2 * gas * L.vpp
        recs.append({
            "op": "collective-permute", "axis": "pipe",
            "count": crossings * max(1, L.token_slices),
            "bytes": crossings * act,
        })
    if L.cp > 1:
        head_dim = model.hidden_size // model.num_attention_heads
        if L.cp_variant == "ulysses":
            count = 4 * model.num_layers * gas  # 2 fwd + 2 bwd per layer
            recs.append({"op": "all-to-all", "axis": "context",
                         "count": count, "bytes": count * act})
        else:
            # ring attention: rotate unrepeated K/V blocks cp-1 times per
            # layer, forward and backward
            kv_block = L.micro_batch_size * (
                model.sequence_length // L.cp
            ) * model.num_kv_heads * head_dim * BF16 * 2  # K and V
            count = 2 * (L.cp - 1) * model.num_layers * gas
            recs.append({"op": "collective-permute", "axis": "context",
                         "count": count, "bytes": count * kv_block})
    return recs


# ------------------------------------------------------------- calibration
@dataclasses.dataclass(frozen=True)
class Calibration:
    """Compute efficiency = fraction of the peak FLOP rate the card
    sustains on compute-bound work (exactly what a measured MFU is on a
    one-device run). Sources are a real MFU or an explicit default that
    says so."""

    compute_efficiency: float
    source: str

    @classmethod
    def default(cls) -> "Calibration":
        return cls(0.5, "default (uncalibrated: no obs run dir or measured "
                        "MFU offered)")

    @classmethod
    def from_mfu(cls, mfu: float, source: str) -> "Calibration":
        eff = min(max(float(mfu), 0.01), 1.0)
        return cls(eff, source)

    @classmethod
    def from_run_dir(cls, run_dir) -> Optional["Calibration"]:
        """Mean MFU of the step records in an obs run dir (the trainer's
        own PaLM-MFU gauge), or None when the run recorded none."""
        from ..obs.report import load_run_dir, mfu_section

        data = load_run_dir(run_dir)
        _, stats = mfu_section(data)
        mean = stats.get("mfu_mean")
        if mean is None or mean <= 0:
            return None
        return cls.from_mfu(mean, f"obs:{run_dir}")

    def to_dict(self) -> dict:
        return {
            "compute_efficiency": round(self.compute_efficiency, 4),
            "source": self.source,
        }


# --------------------------------------------------- per-axis correction
_LABEL_AXES = (
    ("pipe", re.compile(r"(?:^|·)pp(\d+)")),
    ("data", re.compile(r"(?:^|·)dp(\d+)")),
    ("context", re.compile(r"(?:^|·)cp(\d+)")),
    ("model", re.compile(r"(?:^|·)mp(\d+)")),
)


def _axes_of_label(label: str) -> List[str]:
    """The parallel axes a layout label says are active (size > 1);
    ``["compute"]`` for a single-device / pure-replication layout."""
    active = [
        axis for axis, rx in _LABEL_AXES
        if (m := rx.search(label)) and int(m.group(1)) > 1
    ]
    return active or ["compute"]


def _axes_of_layout(layout: Layout) -> List[str]:
    active = [a for a, n in axis_sizes(layout).items() if n > 1]
    return active or ["compute"]


@dataclasses.dataclass(frozen=True)
class AxisCorrection:
    """Per-axis multiplicative correction learned from the calibration
    loop's accumulated (tuner-prediction, span-measured) pairs.

    Every run that exported a prediction leaves a ``tuner-prediction``
    event + measured step time in its run dir; each
    such pair contributes its measured/predicted ratio to the bucket of
    every parallel axis its layout label says is active (``compute``
    when none). A layout's correction is the geometric mean of its
    active axes' factors — so if every dp-dominant run measured 1.5x
    the prediction, dp-heavy candidates are re-priced up before the
    next placement decision (the supervisor's downsize replan reads
    this, so every prior epoch's telemetry sharpens the next layout)."""

    factors: Dict[str, float]
    pairs: int = 0
    source: str = "identity"

    @classmethod
    def identity(cls) -> "AxisCorrection":
        return cls(factors={}, pairs=0, source="identity")

    @classmethod
    def from_pairs(cls, pairs: List[dict], source: str = "pairs"
                   ) -> "AxisCorrection":
        """``pairs``: dicts with ``label``, ``predicted_step_s``,
        ``measured_step_s``. Non-finite / non-positive entries are
        dropped, never fatal (telemetry quality varies per run dir)."""
        logs: Dict[str, List[float]] = {}
        kept = 0
        for p in pairs:
            try:
                predicted = float(p["predicted_step_s"])
                measured = float(p["measured_step_s"])
                label = str(p["label"])
            except (KeyError, TypeError, ValueError):
                continue
            if not (
                math.isfinite(predicted) and math.isfinite(measured)
                and predicted > 0 and measured > 0
            ):
                continue
            kept += 1
            ratio = math.log(measured / predicted)
            for axis in _axes_of_label(label):
                logs.setdefault(axis, []).append(ratio)
        factors = {
            axis: round(math.exp(sum(v) / len(v)), 6)
            for axis, v in logs.items()
        }
        return cls(factors=factors, pairs=kept, source=source)

    @classmethod
    def from_run_dirs(cls, root: Path | str) -> Optional["AxisCorrection"]:
        """Accumulate pairs from the run dirs under ``root``: each
        immediate subdirectory is one run dir (scanned recursively),
        plus ``root``'s own direct files as one more — a flat telemetry
        dir with an incidental subdirectory (checkpoints, plots, a
        control dir) must not lose its own events. Root is read
        NON-recursively so subdirectory telemetry is never counted
        twice. None when no run recorded a usable pair."""
        from ..obs.report import load_run_dir, tuner_section

        root = Path(root)
        if not root.is_dir():
            return None
        subdirs = sorted(p for p in root.iterdir() if p.is_dir())
        pairs: List[dict] = []
        for d in subdirs + [root]:
            data = load_run_dir(d, recursive=d is not root)
            _, stats = tuner_section(data)
            predicted = stats.get("tuner_predicted_step_s")
            measured = stats.get("tuner_measured_step_s")
            if predicted is None or measured is None:
                continue
            preds = [
                e for e in data.lifecycle
                if e.get("event") == "tuner-prediction"
            ]
            label = preds[-1].get("label", "") if preds else ""
            pairs.append({
                "label": label, "predicted_step_s": predicted,
                "measured_step_s": measured,
            })
        if not pairs:
            return None
        return cls.from_pairs(pairs, source=f"run-dirs:{root}")

    def factor_for(self, layout: Layout) -> float:
        """Geometric mean of the layout's active axes' factors (axes
        with no accumulated telemetry contribute 1.0)."""
        logs = [
            math.log(self.factors[a])
            for a in _axes_of_layout(layout) if a in self.factors
        ]
        if not logs:
            return 1.0
        return math.exp(sum(logs) / len(logs))

    def to_dict(self) -> dict:
        return {
            "factors": dict(self.factors), "pairs": self.pairs,
            "source": self.source,
        }


# ------------------------------------------------------------------ scoring
@dataclasses.dataclass
class LayoutScore:
    layout: Layout
    predicted_step_s: float
    compute_s: float
    comm_s: float
    bubble_fraction: float
    comm_by_axis: Dict[str, dict]
    memory_gb: float
    collectives_source: str
    step_tokens: int = 0

    @property
    def tokens_per_s(self) -> float:
        if self.predicted_step_s <= 0:
            return 0.0
        return self.step_tokens / self.predicted_step_s

    def to_dict(self) -> dict:
        return {
            "label": self.layout.label,
            "layout": self.layout.topology_dict(),
            "predicted_step_s": round(self.predicted_step_s, 6),
            "compute_s": round(self.compute_s, 6),
            "comm_s": round(self.comm_s, 6),
            "bubble_fraction": round(self.bubble_fraction, 4),
            "comm_by_axis": self.comm_by_axis,
            "memory_gb_per_device": round(self.memory_gb, 3),
            "collectives_source": self.collectives_source,
            "tokens_per_s": round(self.tokens_per_s, 1),
        }


def memory_gb_per_device(model: ModelSpec, layout: Layout) -> float:
    """Rough device-memory footprint: bf16 params + f32 grads + AdamW fp32 master
    and moments (ZeRO shards optimizer state over dp; stage 3 shards the
    stored params too) + boundary activations. A planning estimate, not
    an allocator."""
    shard = model.parameter_count / (layout.pp * layout.mp)
    zero_div = layout.dp if layout.zero_stage >= 1 else 1
    params = shard * BF16 / (layout.dp if layout.zero_stage >= 3 else 1)
    grads = shard * F32
    opt = shard * 3 * F32 / zero_div
    act = (
        layout.micro_batch_size
        * (model.sequence_length / layout.cp)
        * model.hidden_size
        * (model.num_layers / layout.pp)
        * 16  # residual + attention + mlp working set, bf16
        / (layout.mp if layout.sp else 1)
    )
    return (params + grads + opt + act) / 1e9


def score_layout(
    model: ModelSpec,
    layout: Layout,
    slice_topology: SliceTopology,
    calibration: Optional[Calibration] = None,
    collectives: Optional[List[dict]] = None,
    collectives_source: str = "analytic",
    correction: Optional[AxisCorrection] = None,
) -> LayoutScore:
    """Predicted seconds per optimizer step for ``layout``.

    compute: model FLOPs / world, at the calibrated efficiency of the
    generation's peak, with the token-slice attention penalty applied;
    pipeline layouts replay their actual schedule through the schedule
    simulator (pipe-edge comm priced inside it). Non-pipe collectives
    (data/model/context axes) are priced per axis against the link class
    the slice topology assigns and added to the critical path — no
    overlap is assumed, which is conservative and, like every constant
    here, corrected by the calibration loop. ``correction`` applies the
    accumulated per-axis prediction-vs-measured factors on top.
    """
    cal = calibration or Calibration.default()
    L = layout
    tokens = L.global_batch_size * model.sequence_length

    attn_mult = token_slice_attention_factor(L.token_slices)
    flops_factor = 1.0 + model.attention_flops_fraction * (attn_mult - 1.0)
    device_flops = model.flops_per_token * tokens * flops_factor / L.world
    rate = slice_topology.peak_tflops * 1e12 * cal.compute_efficiency
    compute_s = device_flops / rate

    inventory = collectives if collectives is not None else (
        analytic_collectives(model, layout)
    )
    sizes = axis_sizes(layout)
    comm_by_axis: Dict[str, dict] = {}
    pipe_comm_s = 0.0
    comm_s = 0.0
    for rec in inventory:
        axis = rec["axis"]
        link = link_for_axis(layout, slice_topology, axis)
        n = 1
        for part in axis.split("+"):
            n *= sizes.get(part, 1)
        secs = collective_seconds(
            rec["op"], float(rec["bytes"]), int(rec["count"]), n, link
        )
        slot = comm_by_axis.setdefault(
            axis, {"seconds": 0.0, "bytes": 0, "link": link.name}
        )
        slot["seconds"] += secs
        slot["bytes"] += int(rec["bytes"])
        if axis == "pipe" and rec["op"] == "collective-permute":
            pipe_comm_s += secs  # priced inside the schedule simulator
        else:
            comm_s += secs
    for slot in comm_by_axis.values():
        slot["seconds"] = round(slot["seconds"], 6)

    bubble = 0.0
    if L.pp > 1:
        from ..parallel.pipeline_schedule import simulate_layout

        gas = L.gradient_accumulation_steps
        unit = compute_s / (3.0 * gas)
        # one boundary crossing's wire time at FULL micro-batch payload —
        # the schedule's own duration_scale thins token slices, so the
        # simulator prices the pipe-axis comm (the inventory's pipe
        # permutes), not this function
        link = link_for_axis(layout, slice_topology, "pipe")
        act_bytes = L.micro_batch_size * (
            model.sequence_length // L.cp
        ) * model.hidden_size * BF16
        hop = 0.5 * (
            act_bytes / (link.gbytes_per_s * 1e9) + link.latency_s
        )
        sim = simulate_layout(
            pipe_parallel_size=L.pp,
            gradient_accumulation_steps=gas,
            virtual_size=L.vpp,
            token_slices=L.token_slices,
            durations={
                "forward_pass": unit, "backward_pass": 2.0 * unit,
                "loss": 0.1 * unit, "optimizer_step": 0.1 * unit,
                "load_micro_batch": 0.05 * unit,
                "store_micro_batch": 0.05 * unit,
                "send_activation": hop, "recv_activation": hop,
                "send_grad": hop, "recv_grad": hop,
                "reduce_tied_grads": 0.0,
            },
        )
        step_core = sim["total_time"]
        bubble = sim["bubble_fraction"]
    else:
        step_core = compute_s

    predicted = step_core + comm_s
    if correction is not None:
        predicted *= correction.factor_for(layout)
    score = LayoutScore(
        layout=layout,
        predicted_step_s=predicted,
        compute_s=compute_s,
        comm_s=comm_s + pipe_comm_s,
        bubble_fraction=bubble,
        comm_by_axis=comm_by_axis,
        memory_gb=memory_gb_per_device(model, layout),
        collectives_source=collectives_source,
        step_tokens=tokens,
    )
    return score


def rank_layouts(
    model: ModelSpec,
    layouts: List[Layout],
    slice_topology: SliceTopology,
    calibration: Optional[Calibration] = None,
    correction: Optional[AxisCorrection] = None,
) -> List[LayoutScore]:
    scored = [
        score_layout(model, l, slice_topology, calibration,
                     correction=correction)
        for l in layouts
    ]
    scored.sort(key=lambda s: (s.predicted_step_s, s.layout.label))
    return scored
