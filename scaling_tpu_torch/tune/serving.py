"""Serving-layout search: (mp, replicas, block_size, token_budget) points
(counterpart of ``scaling_tpu/tune/serving.py``).

The training tuner (costmodel.py) answers "where do I place a TRAINING
step"; this module answers the serving twin: given ``D`` devices and a
model, how many model-parallel shards per engine replica (mp), how many
replicas behind the router (replicas = D / mp), what KV block size, and
what per-tick token budget. The scoring reuses the training tuner's
machinery:

- **compute**: a serving tick prices ``token_budget`` tokens at the
  inference FLOP rate (2 FLOPs per parameter per token plus the attention
  window term), divided over the replica's mp shards at the calibrated
  efficiency of the generation's peak. Small blocks pay a per-block cost
  in the paged kernel (K1, ``csrc/paged_attention.cu``: each block is one
  block-table lookup and one tile of K/V loads, ``1 +
  PAGED_BLOCK_OVERHEAD / block_size``); large blocks pay internal
  fragmentation instead (a sequence wastes half a block on average),
  priced in memory.
- **comm**: mp > 1 costs the Megatron activation all-reduces training's
  model axis pays — 2 per layer forward — priced NVLink-vs-NIC by the
  training tuner's ``link_for_axis``.
- **memory**: bf16 params / mp + the sharded KV pool must fit the card's
  memory; infeasible points are dropped, not ranked.
- **calibration**: the analytic tick time is scaled by a measured factor
  from real serve run dirs (:class:`ServeCalibration` — mean
  ``serve.mixed``/``serve.decode`` span seconds vs the model's prediction
  for THAT run's engine shape, read from the serve-summary's ``engine``
  facts).

``python -m scaling_tpu_torch.tune --serve`` ranks the space, pins a
golden (``tune/goldens/tune_serve_1dev_0.5b.json``), and
``--emit-config`` writes a dict ``serve bench --config`` runs directly.
The port serves one replica on one device: the enumeration of more
devices waits for its several-device serving.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from .costmodel import (
    BF16,
    Calibration,
    LinkClass,
    SliceTopology,
    collective_seconds,
    link_for_axis,
)
from .layouts import Layout, ModelSpec

# K1's per-block cost in token-equivalents: the kernel's time over a fixed
# context multiplies by (1 + OVERHEAD / block_size) as the block shrinks.
# From K1 alone at block sizes 8, 16 and 32 over one context (chip_smoke.py
# phase 18 (a), fit of t(bs) = c * (1 + OVERHEAD / bs); H100 80GB HBM3,
# 700 W): 0.0364 / 0.0364 / 0.0362 ms, O = 0.06. K1 walks the context in
# 64-slot K/V tiles gathered through the block table whatever the block
# size, so the block costs next to nothing (the JAX kernel pays one grid
# step per block).
PAGED_BLOCK_OVERHEAD = 0.06

# steady-state KV residency per slot of token budget: the pool must hold
# the CONTEXTS of every in-flight sequence, not just the tick's new
# tokens; the emitted config scales num_blocks from it.
POOL_TOKENS_PER_BUDGET_TOKEN = 16.0

# generation -> device memory a replica may fill (GB): the H100 SXM5's
# 80 GB of HBM3 (data sheet, 700 W board)
HBM_GB = {
    "h100_sxm": 80.0,
}

# the head dims K1 is built for (ops/paged_attention.py HEAD_DIMS)
K1_HEAD_DIMS = (64, 128)


@dataclasses.dataclass(frozen=True)
class ServingPoint:
    """One serving-layout candidate for ``mp * replicas`` chips."""

    mp: int
    replicas: int
    block_size: int
    token_budget: int
    num_slots: int = 8

    @property
    def world(self) -> int:
        return self.mp * self.replicas

    @property
    def label(self) -> str:
        return (f"mp{self.mp}·r{self.replicas}·bs{self.block_size}"
                f"·tb{self.token_budget}")

    def layout(self, mbs: int = 1) -> Layout:
        """The serving point as a training-tuner Layout (dp = replicas):
        what makes ``link_for_axis`` price the mp axis with the SAME
        stride/domain rules training placement uses."""
        return Layout(pp=1, dp=self.replicas, cp=1, mp=self.mp,
                      micro_batch_size=mbs, gradient_accumulation_steps=1)

    def to_config(self, model: Optional[ModelSpec] = None) -> dict:
        """A runnable serving config: the dict ``serve bench --config``
        consumes (and a deployment template for the real fleet)."""
        pool_tokens = int(self.token_budget * POOL_TOKENS_PER_BUDGET_TOKEN)
        num_blocks = max(2, pool_tokens // self.block_size + 1)
        cfg = {
            "mp": self.mp,
            "replicas": self.replicas,
            "block_size": self.block_size,
            "token_budget": self.token_budget,
            "num_slots": self.num_slots,
            "num_blocks": num_blocks,
        }
        if model is not None:
            cfg["model"] = {
                "hidden_size": model.hidden_size,
                "num_layers": model.num_layers,
                "num_kv_heads": model.num_kv_heads,
            }
        return cfg


def enumerate_serving_points(
    n_devices: int,
    model: ModelSpec,
    block_sizes: Sequence[int] = (8, 16, 32),
    token_budgets: Sequence[int] = (128, 256, 512),
    num_slots: int = 8,
) -> List[ServingPoint]:
    """Every (mp, replicas=D/mp, block_size, token_budget) the model
    shape admits: mp must divide the device count AND the q/kv heads (the
    pool shards kv heads over the model axis, so the tuner never ranks an
    unbuildable point)."""
    points: List[ServingPoint] = []
    for mp in range(1, n_devices + 1):
        if n_devices % mp:
            continue
        if model.num_attention_heads % mp or model.num_kv_heads % mp:
            continue
        replicas = n_devices // mp
        for bs in block_sizes:
            for tb in token_budgets:
                points.append(ServingPoint(
                    mp=mp, replicas=replicas, block_size=bs,
                    token_budget=tb, num_slots=num_slots,
                ))
    points.sort(key=lambda p: (p.mp, p.block_size, p.token_budget))
    return points


def serve_flops_per_token(model: ModelSpec, avg_context: float) -> float:
    """Inference FLOPs per generated/prefilled token: 2 per parameter
    (one forward MAC each) plus the attention window reads —
    ``4 * layers * hidden * context`` (QK^T and PV over the cached
    context), the forward third of PaLM appendix-B's 12 L H S."""
    return (
        2.0 * model.parameter_count
        + 4.0 * model.num_layers * model.hidden_size * avg_context
    )


def predict_tick_seconds(
    model: ModelSpec,
    point: ServingPoint,
    topo: SliceTopology,
    calibration: Optional[Calibration] = None,
) -> Dict[str, float]:
    """Analytic seconds for ONE engine tick of ``token_budget`` tokens
    on one replica: compute over the mp shards + the mp activation
    all-reduces, the comm priced by the link class the slice topology
    assigns to the model axis (NVLink inside a domain, the NIC across)."""
    cal = calibration or Calibration.default()
    avg_context = point.token_budget * POOL_TOKENS_PER_BUDGET_TOKEN / (
        2.0 * point.num_slots
    )  # half the steady-state per-slot residency
    flops = point.token_budget * serve_flops_per_token(model, avg_context)
    rate = topo.peak_tflops * 1e12 * cal.compute_efficiency
    block_factor = 1.0 + PAGED_BLOCK_OVERHEAD / point.block_size
    compute_s = flops * block_factor / (rate * point.mp)
    comm_s = 0.0
    link: LinkClass = topo.nvlink
    if point.mp > 1:
        link = link_for_axis(point.layout(), topo, "model")
        # Megatron TP inference forward: 2 activation ARs per layer over
        # the tick's activations (no backward at serving)
        count = 2 * model.num_layers
        payload = count * point.token_budget * model.hidden_size * BF16
        comm_s = collective_seconds(
            "all-reduce", float(payload), count, point.mp, link
        )
    return {
        "compute_s": compute_s,
        "comm_s": comm_s,
        "tick_s": compute_s + comm_s,
        "link": link.name,
    }


def serving_memory_gb(model: ModelSpec, point: ServingPoint) -> float:
    """Per-device memory: bf16 params / mp + the kv-head-sharded pool.
    Fragmentation: each in-flight sequence wastes ~half a block."""
    params = model.parameter_count * BF16 / point.mp
    head = model.hidden_size // model.num_attention_heads
    pool_tokens = point.token_budget * POOL_TOKENS_PER_BUDGET_TOKEN
    pool_tokens += point.num_slots * point.block_size / 2.0  # fragmentation
    pool = (
        model.num_layers * 2.0 * pool_tokens
        * (model.num_kv_heads / point.mp) * head * BF16
    )
    return (params + pool) / 1e9


@dataclasses.dataclass
class ServingScore:
    point: ServingPoint
    tokens_per_s: float
    tick_s: float
    compute_s: float
    comm_s: float
    memory_gb: float
    link: str

    def to_dict(self) -> dict:
        return {
            "label": self.point.label,
            "mp": self.point.mp,
            "replicas": self.point.replicas,
            "block_size": self.point.block_size,
            "token_budget": self.point.token_budget,
            "tokens_per_s": round(self.tokens_per_s, 1),
            "tick_s": round(self.tick_s, 6),
            "compute_s": round(self.compute_s, 6),
            "comm_s": round(self.comm_s, 6),
            "memory_gb_per_chip": round(self.memory_gb, 3),
            "link": self.link,
        }


def score_serving_point(
    model: ModelSpec,
    point: ServingPoint,
    topo: SliceTopology,
    calibration: Optional[Calibration] = None,
    serve_calibration: Optional["ServeCalibration"] = None,
) -> Optional[ServingScore]:
    """Fleet tokens/s for one point, or None when it does not fit the
    generation's memory (an unrankable point, not a slow one)."""
    memory = serving_memory_gb(model, point)
    if memory > HBM_GB[topo.generation]:
        return None
    pred = predict_tick_seconds(model, point, topo, calibration)
    tick_s = pred["tick_s"]
    if serve_calibration is not None:
        tick_s *= serve_calibration.factor
    tokens_per_s = point.replicas * point.token_budget / tick_s
    return ServingScore(
        point=point, tokens_per_s=tokens_per_s, tick_s=tick_s,
        compute_s=pred["compute_s"], comm_s=pred["comm_s"],
        memory_gb=memory, link=pred["link"],
    )


def rank_serving_points(
    model: ModelSpec,
    points: Sequence[ServingPoint],
    topo: SliceTopology,
    calibration: Optional[Calibration] = None,
    serve_calibration: Optional["ServeCalibration"] = None,
) -> List[ServingScore]:
    scored = [
        s for p in points
        if (s := score_serving_point(model, p, topo, calibration,
                                     serve_calibration)) is not None
    ]
    scored.sort(key=lambda s: (-s.tokens_per_s, s.point.label))
    return scored


# ---------------------------------------------------------- calibration
@dataclasses.dataclass(frozen=True)
class ServeCalibration:
    """Measured-vs-analytic tick-time factor from real serve run dirs.

    A serve bench run leaves ``serve.mixed`` / ``serve.decode`` spans
    (the device tick) and a serve-summary carrying the engine SHAPE it
    ran (``engine``: mp/num_slots/block_size/token_budget...). The
    factor is measured mean tick seconds over the analytic prediction
    for that exact shape — applied multiplicatively to every candidate,
    the serving twin of the training tuner's
    prediction-vs-span-measured loop."""

    factor: float
    source: str
    ticks: int = 0

    @classmethod
    def identity(cls) -> "ServeCalibration":
        return cls(1.0, "identity")

    @classmethod
    def from_run_dir(cls, run_dir, model: ModelSpec,
                     topo: SliceTopology,
                     calibration: Optional[Calibration] = None,
                     ) -> Optional["ServeCalibration"]:
        """None when the run dir has no serve spans or no engine facts
        in its serve-summary."""
        from ..obs.report import load_run_dir

        data = load_run_dir(run_dir)
        spans = [
            sp for sp in data.spans
            if sp.get("span") in ("serve.mixed", "serve.decode")
            and sp.get("dur_s") is not None
        ]
        summaries = [
            e for e in data.lifecycle if e.get("event") == "serve-summary"
        ]
        if not spans or not summaries:
            return None
        eng = summaries[-1].get("engine")
        if not isinstance(eng, dict):
            return None
        try:
            point = ServingPoint(
                mp=int(eng.get("mp", 1)),
                replicas=int(eng.get("replicas", 1)),
                block_size=int(eng["block_size"]),
                token_budget=int(eng["token_budget"]),
                num_slots=int(eng["num_slots"]),
            )
        except (KeyError, TypeError, ValueError):
            return None
        measured = sum(float(sp["dur_s"]) for sp in spans) / len(spans)
        predicted = predict_tick_seconds(
            model, point, topo, calibration
        )["tick_s"]
        if predicted <= 0 or measured <= 0:
            return None
        return cls(
            factor=measured / predicted,
            source=f"serve-spans:{run_dir}",
            ticks=len(spans),
        )

    def to_dict(self) -> dict:
        return {
            "factor": round(self.factor, 6),
            "source": self.source,
            "ticks": self.ticks,
        }


# -------------------------------------------------------------- golden
GOLDEN_DIR = Path(__file__).resolve().parent / "goldens"
GOLDEN_RTOL = 0.02


def serve_golden_path(devices: int, model_name: str) -> Path:
    return GOLDEN_DIR / f"tune_serve_{devices}dev_{model_name}.json"


def check_serve_golden(payload: dict, path: Path) -> List[str]:
    """Ranking drift vs the pinned serving golden (labels exact,
    tokens/s within the band) — mirrors the training tuner's pin."""
    import json

    if not path.is_file():
        return [f"no serving golden at {path} (run --repin-golden)"]
    golden = json.loads(path.read_text())
    drift: List[str] = []
    g = [(r["label"], r["tokens_per_s"]) for r in golden["ranked"]]
    c = [(r["label"], r["tokens_per_s"]) for r in payload["ranked"]]
    if [l for l, _ in g] != [l for l, _ in c]:
        drift.append(
            f"serving ranking changed: golden {[l for l, _ in g][:4]}... "
            f"!= current {[l for l, _ in c][:4]}..."
        )
    for (gl, gs), (cl, cs) in zip(g, c):
        if gl == cl and gs and abs(cs - gs) > GOLDEN_RTOL * gs:
            drift.append(
                f"{gl}: tokens/s {gs:.1f} -> {cs:.1f} "
                f"(> {GOLDEN_RTOL:.0%} band)"
            )
    return drift


# ----------------------------------------------------------- placement
@dataclasses.dataclass(frozen=True)
class HostCapacity:
    """One machine of the serving fleet as the placement axis sees it:
    ``slots`` replica processes at most, ``hbm_gb`` usable accelerator
    memory for ALL of them together."""

    host_id: int
    hostname: str
    slots: int
    hbm_gb: float = float("inf")


class PlacementPlan:
    """WHERE the next replica may spawn: per-host slot + memory
    feasibility over a fleet of hosts. Pure policy, no I/O and no clocks.
    The port serves on one host: ``tune --serve-hostsfile`` (the JAX
    tuner's placement table over a hostsfile) waits for several-host
    serving, and this class is its math, ported unchanged."""

    def __init__(self, hosts: Sequence[HostCapacity],
                 per_replica_gb: float = 0.0):
        if not hosts:
            raise ValueError("a placement plan needs at least one host")
        ids = [h.host_id for h in hosts]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate host ids {ids}")
        self.hosts = list(hosts)
        self.per_replica_gb = float(per_replica_gb)

    @classmethod
    def from_pool(cls, pool: Dict[str, int],
                  per_replica_gb: float = 0.0,
                  hbm_gb: float = float("inf")) -> "PlacementPlan":
        """From a runner resource pool (``runner.get_resource_pool`` —
        ordered {hostname: slots}); host ids follow hostsfile order."""
        return cls(
            [
                HostCapacity(i, hostname, max(int(slots), 1), hbm_gb)
                for i, (hostname, slots) in enumerate(pool.items())
            ],
            per_replica_gb=per_replica_gb,
        )

    def host(self, host_id: int) -> HostCapacity:
        for h in self.hosts:
            if h.host_id == host_id:
                return h
        raise KeyError(f"no host {host_id} in the placement plan")

    def add_host(self, hostname: str, slots: int = 1,
                 hbm_gb: float = float("inf")) -> HostCapacity:
        """Admit a LEASED host into the plan mid-run (the elastic
        capacity arbiter borrowed it from training —
        ``resilience.capacity``): next free id, immediately eligible
        for ``next_host`` placement. A hostname already planned gains
        slots instead of a duplicate row (a second lease of the same
        machine's remaining chips)."""
        for i, h in enumerate(self.hosts):
            if h.hostname == hostname:
                grown = HostCapacity(
                    h.host_id, h.hostname, h.slots + max(int(slots), 1),
                    h.hbm_gb,
                )
                self.hosts[i] = grown
                return grown
        hid = max((h.host_id for h in self.hosts), default=-1) + 1
        cap = HostCapacity(hid, hostname, max(int(slots), 1), hbm_gb)
        self.hosts.append(cap)
        return cap

    def remove_host(self, hostname: str, slots: Optional[int] = None
                    ) -> None:
        """Give a leased host back (reclaim completed): drop its row, or
        shrink it by ``slots`` when only part of the machine was leased.
        Unknown hostnames are a no-op — release is idempotent."""
        for i, h in enumerate(self.hosts):
            if h.hostname != hostname:
                continue
            if slots is not None and h.slots > slots:
                self.hosts[i] = HostCapacity(
                    h.host_id, h.hostname, h.slots - slots, h.hbm_gb
                )
            else:
                del self.hosts[i]
            return

    def hostname(self, host_id: int) -> str:
        return self.host(host_id).hostname

    def feasible(self, host_id: int, count: int) -> bool:
        """Can host ``host_id``, already running ``count`` replicas,
        take one more? Slot-bound AND memory-bound: ``count + 1``
        replicas' HBM must fit the host's budget."""
        h = self.host(host_id)
        if count >= h.slots:
            return False
        return (count + 1) * self.per_replica_gb <= h.hbm_gb

    def next_host(self, counts: Dict[int, int]) -> Optional[int]:
        """The least-loaded feasible host (lowest id breaks ties), or
        None when no host can take another replica. ``counts`` maps
        host_id -> replicas currently placed there (missing = 0)."""
        best = None
        for h in self.hosts:
            count = int(counts.get(h.host_id, 0))
            if not self.feasible(h.host_id, count):
                continue
            if best is None or count < best[0]:
                best = (count, h.host_id)
        return None if best is None else best[1]

    def initial_assignment(self, n: int) -> List[int]:
        """Host ids for replicas ``0..n-1`` — least-loaded round-robin
        through ``next_host`` so the initial spread and the autoscale
        spread follow the SAME rule. Raises when the fleet cannot hold
        ``n`` replicas (better a loud launch error than a worker that
        OOMs or oversubscribes its host mid-run)."""
        counts: Dict[int, int] = {}
        out: List[int] = []
        for r in range(n):
            hid = self.next_host(counts)
            if hid is None:
                cap = sum(h.slots for h in self.hosts)
                raise ValueError(
                    f"placement infeasible: replica {r} of {n} has no "
                    f"host with a free slot that fits "
                    f"{self.per_replica_gb:.2f} GB/replica "
                    f"(fleet capacity {cap} slot(s) over "
                    f"{len(self.hosts)} host(s))"
                )
            counts[hid] = counts.get(hid, 0) + 1
            out.append(hid)
        return out

    def to_payload(self) -> List[dict]:
        """The tune payload's ``placement`` table: per-host capacity in
        replicas, both slot- and HBM-bound."""
        rows = []
        for h in self.hosts:
            if self.per_replica_gb > 0 and h.hbm_gb != float("inf"):
                mem_cap = int(h.hbm_gb // self.per_replica_gb)
            else:
                mem_cap = None
            rows.append({
                "host_id": h.host_id,
                "hostname": h.hostname,
                "slots": h.slots,
                "hbm_gb": (
                    None if h.hbm_gb == float("inf")
                    else round(h.hbm_gb, 2)
                ),
                "max_replicas_by_memory": mem_cap,
                "max_replicas": (
                    h.slots if mem_cap is None else min(h.slots, mem_cap)
                ),
            })
        return rows
