"""scaling_tpu_torch.tune — the layout tuner (counterpart of
``scaling_tpu/tune/``).

Enumerates the valid layouts of a model on a device count, scores each
against a comm/compute cost model — per-axis collective volumes priced by
NVLink-vs-NIC link class, pipeline bubbles replayed through the schedule
simulator, compute calibrated from a real MFU — and emits a ranked
report plus a ready-to-run ``TopologyConfig``. The serving twin ranks
(mp, replicas, block_size, token_budget) points and emits the config
``serve bench --config`` runs.

The port trains and serves on one device: there the training space is
the micro-batch ladder and the serving space the block sizes and token
budgets. Enumerating more devices raises NotImplementedError until the
port runs on several.

Library surface::

    from scaling_tpu_torch import tune
    best, ranked = tune.best_layout("0.5b", tune.SliceTopology(chips=1))

CLI::

    python -m scaling_tpu_torch.tune --devices 1 --model 0.5b --mbs-ladder 4,8,16,32

The closed loop: the CLI's prediction for the chosen layout is exported
as ``SCALING_TPU_TUNER_PREDICTION``; the port's trainer logs it as a
``tuner-prediction`` event into the run's events stream, and
``python -m scaling_tpu_torch.obs report`` renders a tuner section
comparing the prediction against span-measured step time
(``--assert-tuner-calibration`` gates it).

Import stays light (stdlib only): ``prediction_from_env`` is safe
anywhere the trainer runs.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

PREDICTION_ENV = "SCALING_TPU_TUNER_PREDICTION"

# re-exported lazily (PEP 562) so importing the package costs nothing
_LAZY = {
    "ModelSpec": "layouts", "Layout": "layouts", "BENCH_MODELS": "layouts",
    "enumerate_layouts": "layouts",
    "SliceTopology": "costmodel", "Calibration": "costmodel",
    "AxisCorrection": "costmodel",
    "LayoutScore": "costmodel", "score_layout": "costmodel",
    "rank_layouts": "costmodel", "analytic_collectives": "costmodel",
    "link_for_axis": "costmodel",
    "token_slice_attention_factor": "costmodel",
    # serving layouts
    "ServingPoint": "serving", "ServingScore": "serving",
    "ServeCalibration": "serving",
    "enumerate_serving_points": "serving",
    "score_serving_point": "serving", "rank_serving_points": "serving",
}

__all__ = sorted(_LAZY) + [
    "PREDICTION_ENV", "best_layout", "prediction_from_env", "rank_of_layout",
]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def prediction_from_env() -> Optional[dict]:
    """The tuner prediction a launcher exported for this run, sanitized,
    or None. The trainer logs the result as a ``tuner-prediction``
    lifecycle event so the obs report can close the calibration loop;
    malformed payloads return None (a bad export must not kill a run)."""
    raw = os.environ.get(PREDICTION_ENV)
    if not raw:
        return None
    try:
        payload = json.loads(raw)
    except ValueError:
        return None
    if not isinstance(payload, dict):
        return None
    out: dict = {}
    try:
        out["predicted_step_s"] = float(payload["predicted_step_s"])
    except (KeyError, TypeError, ValueError):
        return None  # a prediction without a number cannot calibrate
    for key in ("label", "source", "collectives_source"):
        if isinstance(payload.get(key), str):
            out[key] = payload[key][:200]
    for key in ("world_size",):
        try:
            out[key] = int(payload[key])
        except (KeyError, TypeError, ValueError):
            pass
    return out


def best_layout(
    model_cfg,
    slice_topology=None,
    *,
    global_batch_size: int = 64,
    micro_batch_size: int = 8,
    calibration=None,
    correction=None,
) -> Tuple["Layout", list]:
    """Search the layout space of ``model_cfg`` (a ``ModelSpec``, a
    transformer-architecture config object, or a bench model name like
    ``"0.5b"``) over ``slice_topology`` (one device by default) and
    return ``(best_layout, ranked_scores)``. ``correction`` (an
    ``AxisCorrection``) re-prices candidates by the accumulated
    prediction-vs-measured telemetry. More than one device raises
    NotImplementedError (``enumerate_layouts``)."""
    from .costmodel import SliceTopology, rank_layouts
    from .layouts import BENCH_MODELS, ModelSpec, enumerate_layouts

    if isinstance(model_cfg, str):
        model = BENCH_MODELS[model_cfg]
    elif isinstance(model_cfg, ModelSpec):
        model = model_cfg
    else:
        model = ModelSpec.from_arch(model_cfg)
    topo = slice_topology or SliceTopology(chips=1)
    layouts = enumerate_layouts(
        topo.chips, model, global_batch_size=global_batch_size,
        micro_batch_size=micro_batch_size,
    )
    if not layouts:
        raise ValueError(
            f"no valid layout of this model on {topo.chips} device(s) at "
            f"gbs={global_batch_size} mbs={micro_batch_size}"
        )
    ranked = rank_layouts(model, layouts, topo, calibration,
                          correction=correction)
    return ranked[0].layout, ranked


def rank_of_layout(
    model_cfg,
    layout,
    slice_topology=None,
    *,
    calibration=None,
) -> Tuple[int, int, "LayoutScore"]:
    """Where ``layout`` lands in the tuner's ranking of its own search
    space: ``(rank, space_size, score)``, 1-based. A layout outside the
    enumerated space is scored directly and ranked by insertion."""
    from .costmodel import SliceTopology, rank_layouts, score_layout
    from .layouts import BENCH_MODELS, ModelSpec, enumerate_layouts

    if isinstance(model_cfg, str):
        model = BENCH_MODELS[model_cfg]
    elif isinstance(model_cfg, ModelSpec):
        model = model_cfg
    else:
        model = ModelSpec.from_arch(model_cfg)
    topo = slice_topology or SliceTopology(chips=layout.world)
    layouts = enumerate_layouts(
        topo.chips, model,
        global_batch_size=layout.global_batch_size,
        micro_batch_size=layout.micro_batch_size,
    )
    ranked = rank_layouts(model, layouts, topo, calibration)
    for i, s in enumerate(ranked):
        if s.layout.key() == layout.key():
            return i + 1, len(ranked), s
    score = score_layout(model, layout, topo, calibration)
    rank = 1 + sum(
        1 for s in ranked if s.predicted_step_s <= score.predicted_step_s
    )
    return rank, len(ranked) + 1, score
