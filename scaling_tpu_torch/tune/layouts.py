"""Layout space: every valid (pp, dp, cp, mp, ...) placement of a model
on a device count (counterpart of ``scaling_tpu/tune/layouts.py``).

The tuner enumerates every factorization of the device count over the
four mesh axes plus the schedule/optimizer knobs (zero stage,
interleaved virtual stages, TeraPipe token slices, ring/ulysses context
parallelism), and keeps exactly those that pass the validity rules the
port's config enforces — each candidate is validated by constructing the
port's ``TopologyConfig`` (``topology/config.py``), so the tuner can
never rank a layout the trainer would reject — plus the model-shape
divisibility rules the layer stack imposes.

The port's ``TopologyConfig`` admits data, model and pipeline
parallelism (virtual stages too), so a hand-built ``Layout`` of those
axes validates and is scored. ``enumerate_layouts`` over more than one
device raises NotImplementedError by name: the search of a device count's
layouts is not ported, and on one device the space is the micro-batch
ladder.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """The model shape the cost model prices. Mirrors the fields the
    FLOPs estimators read (models/transformer/utils/get_tflops.py — the
    parameter-count and PaLM appendix-B formulas are duplicated here so
    the tuner imports no torch; equality with the originals is pinned by
    tests/test_torch_tune.py)."""

    hidden_size: int
    num_layers: int
    num_attention_heads: int
    num_kv_heads: int
    sequence_length: int
    vocab_size: int
    mlp_factor: float = 2.75
    glu: bool = True
    moe: bool = False

    @property
    def parameter_count(self) -> int:
        per_layer = 4 * self.hidden_size * self.hidden_size + (
            3 if self.glu else 2
        ) * int(self.hidden_size * self.hidden_size * self.mlp_factor)
        return self.num_layers * per_layer + self.vocab_size * self.hidden_size

    @property
    def flops_per_token(self) -> float:
        """PaLM appendix-B train FLOPs/token: 6N + 12 L H S."""
        return (
            6.0 * self.parameter_count
            + 12.0 * self.num_layers * self.hidden_size * self.sequence_length
        )

    @property
    def attention_flops_fraction(self) -> float:
        """Share of ``flops_per_token`` in the attention quadratic term —
        the part a token-sliced cache path re-prices."""
        return (
            12.0 * self.num_layers * self.hidden_size * self.sequence_length
            / self.flops_per_token
        )

    @classmethod
    def from_arch(cls, arch) -> "ModelSpec":
        """Build from anything with the transformer-architecture field
        names (a ``TransformerArchitectureConfig``, a plain dict, the
        audit's config objects)."""

        def get(name, default=None):
            if isinstance(arch, dict):
                return arch.get(name, default)
            return getattr(arch, name, default)

        mlp_type = get("mlp_type", "swiglu")
        mlp_type = getattr(mlp_type, "value", mlp_type)
        return cls(
            hidden_size=int(get("hidden_size")),
            num_layers=int(get("num_layers")),
            num_attention_heads=int(get("num_attention_heads")),
            num_kv_heads=int(
                get("attention_num_kv_heads", get("num_attention_heads"))
            ),
            sequence_length=int(get("sequence_length")),
            vocab_size=int(get("vocab_size")),
            mlp_factor=float(get("mlp_factor", 4.0)),
            glu=mlp_type == "swiglu",
            moe=mlp_type == "moe",
        )


# The bench models (``train/bench.py`` ``MODELS``, ``bench.py``'s arms):
# heads = hidden // 128, kv heads = max(1, hidden // 512), seq 2048, swiglu
# 2.75 — kept in sync by the ModelSpec-vs-get_tflops pin test.
BENCH_MODELS = {
    "0.5b": ModelSpec(
        hidden_size=2048, num_layers=8, num_attention_heads=16,
        num_kv_heads=4, sequence_length=2048, vocab_size=32768,
        mlp_factor=2.75, glu=True,
    ),
    "1b": ModelSpec(
        hidden_size=2048, num_layers=20, num_attention_heads=16,
        num_kv_heads=4, sequence_length=2048, vocab_size=32768,
        mlp_factor=2.75, glu=True,
    ),
}


@dataclasses.dataclass(frozen=True)
class Layout:
    """One placement candidate: the mesh factorization plus the schedule
    and optimizer knobs. ``sp`` follows the JAX package's rule (Megatron
    SP whenever TP is on and context parallelism is off) rather than
    being a free axis."""

    pp: int
    dp: int
    cp: int
    mp: int
    micro_batch_size: int
    gradient_accumulation_steps: int
    sp: bool = False
    cp_variant: str = "ring"
    zero_stage: int = 1
    vpp: int = 1
    token_slices: int = 1
    # set when this layout came from an mbs-ladder enumeration (several
    # candidates differ ONLY in micro_batch_size): the label then names
    # the mbs so ranked rows stay distinguishable. Off by default so
    # single-mbs labels — and the pinned tune golden — are unchanged.
    mbs_in_label: bool = False

    @property
    def world(self) -> int:
        return self.pp * self.dp * self.cp * self.mp

    @property
    def global_batch_size(self) -> int:
        return self.micro_batch_size * self.gradient_accumulation_steps * self.dp

    def key(self) -> Tuple:
        """Identity for matching a layout against the space."""
        return (
            self.pp, self.dp, self.cp, self.mp,
            self.cp_variant if self.cp > 1 else "-",
            self.zero_stage, self.vpp, self.token_slices,
        )

    @property
    def label(self) -> str:
        parts = [f"pp{self.pp}", f"dp{self.dp}"]
        if self.cp > 1:
            parts.append(f"cp{self.cp}:{self.cp_variant}")
        parts.append(f"mp{self.mp}")
        if self.sp:
            parts.append("sp")
        if self.mbs_in_label:
            parts.append(f"mbs{self.micro_batch_size}")
        parts.append(f"z{self.zero_stage}")
        if self.vpp > 1:
            parts.append(f"v{self.vpp}")
        if self.token_slices > 1:
            parts.append(f"ts{self.token_slices}")
        return "·".join(parts)

    def topology_dict(self) -> dict:
        """The exact dict ``TopologyConfig.from_dict`` (and the trainer's
        entry points) consume — the tuner's output IS a runnable config,
        not a description of one."""
        return {
            "world_size": self.world,
            "pipe_parallel_size": self.pp,
            "data_parallel_size": self.dp,
            "context_parallel_size": self.cp,
            "model_parallel_size": self.mp,
            "context_parallel_variant": self.cp_variant,
            "micro_batch_size": self.micro_batch_size,
            "gradient_accumulation_steps": self.gradient_accumulation_steps,
            "global_batch_size": self.global_batch_size,
            "pipe_virtual_size": self.vpp,
            "pipe_token_slices": self.token_slices,
            "sequence_parallel": self.sp,
        }

    def validate(self) -> Optional[str]:
        """None when the port's ``TopologyConfig`` accepts this layout,
        else the rejection reason — the tuner reuses the production
        validity rules instead of reimplementing them."""
        from ..topology.config import TopologyConfig

        try:
            TopologyConfig.from_dict(self.topology_dict())
        except Exception as e:  # pydantic wraps the validator's asserts
            return str(e)
        return None


def _factorizations(n: int) -> Iterator[Tuple[int, int, int, int]]:
    """All ordered (pp, dp, cp, mp) with pp*dp*cp*mp == n."""
    divs = [d for d in range(1, n + 1) if n % d == 0]
    for pp in divs:
        for dp in [d for d in divs if (n // pp) % d == 0]:
            rem = n // (pp * dp)
            for cp in [d for d in divs if rem % d == 0]:
                yield pp, dp, cp, rem // cp


def _model_fits(model: ModelSpec, pp: int, dp: int, cp: int, mp: int,
                cp_variant: str, vpp: int, slices: int) -> bool:
    """Divisibility the layer stack imposes beyond TopologyConfig."""
    heads, kv = model.num_attention_heads, model.num_kv_heads
    if heads % mp or kv % mp:
        return False  # TP shards heads
    if model.num_layers % (pp * vpp):
        return False  # uniform stage (chunk) partition
    if cp > 1:
        if model.sequence_length % cp:
            return False
        if cp_variant == "ulysses" and (heads % cp or kv % cp):
            return False  # ulysses all-to-alls heads across cp
    if slices > 1 and model.sequence_length % slices:
        return False
    return True


def enumerate_layouts(
    n_devices: int,
    model: ModelSpec,
    global_batch_size: int,
    micro_batch_size: int,
    virtual_options: Sequence[int] = (2,),
    slice_options: Sequence[int] = (2,),
    mbs_ladder: Optional[Sequence[int]] = None,
) -> List[Layout]:
    """Every valid layout of ``model`` on ``n_devices`` at the given
    batch hierarchy. Candidates that any production rule rejects
    (TopologyConfig validation or layer-stack divisibility) are dropped;
    the result is deterministic and sorted by ``key()`` (then mbs).

    ``mbs_ladder`` additionally enumerates each listed micro-batch size
    alongside ``micro_batch_size`` (duplicates collapse): the global
    batch is fixed, so a smaller mbs means proportionally more
    accumulation steps — cheaper activation memory and a thinner
    pipeline bubble (more micro-batches fill the schedule), priced by
    the same cost model. Ladder candidates carry the mbs in their label
    so the ranked report stays readable; without a ladder labels (and
    the pinned golden) are byte-identical to before.

    ``n_devices > 1`` raises NotImplementedError: the search over several
    devices is not ported (a hand-built layout validates and is scored)."""
    if n_devices > 1:
        raise NotImplementedError(
            f"enumerate_layouts on {n_devices} devices is not ported: the tuner searches one "
            "device's micro-batch ladder (score a hand-built Layout with "
            "costmodel.score_layout)")
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    mbs_options = sorted({int(micro_batch_size), *(mbs_ladder or ())})
    ladder = len(mbs_options) > 1
    out: List[Layout] = []
    for mbs in mbs_options:
        if mbs < 1:
            raise ValueError(f"micro batch sizes must be >= 1, got {mbs}")
        for pp, dp, cp, mp in _factorizations(n_devices):
            if global_batch_size % (mbs * dp):
                continue
            gas = global_batch_size // (mbs * dp)
            sp = mp > 1 and cp == 1 and not model.moe
            cp_variants = ["ring", "ulysses"] if cp > 1 else ["ring"]
            zero_stages = [1] + ([3] if dp > 1 else [])
            schedules: List[Tuple[int, int]] = [(1, 1)]
            if pp > 1:
                schedules += [(v, 1) for v in virtual_options if v > 1]
                schedules += [(1, s) for s in slice_options if s > 1]
            for cpv in cp_variants:
                for zero in zero_stages:
                    for vpp, slices in schedules:
                        if not _model_fits(model, pp, dp, cp, mp, cpv,
                                           vpp, slices):
                            continue
                        layout = Layout(
                            pp=pp, dp=dp, cp=cp, mp=mp,
                            micro_batch_size=mbs,
                            gradient_accumulation_steps=gas, sp=sp,
                            cp_variant=cpv, zero_stage=zero, vpp=vpp,
                            token_slices=slices, mbs_in_label=ladder,
                        )
                        if layout.validate() is None:
                            out.append(layout)
    out.sort(key=lambda l: l.key() + (l.micro_batch_size,))
    return out
