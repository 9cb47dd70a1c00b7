"""Fusion schedules: the paper's v0..v3 pipeline evolution (torch port).

    v0  layer by layer (baseline)
    v1  fused pixel-wise, sequential
    v2  inter-stage pipeline
    v3  intra-stage pipeline, realised as the row-tile dataflow

``run_block(x, params, schedule)`` runs an int8 DSC block under a schedule.
This slice ports v0 and v3; all schedules give bit-identical outputs.
"""

from __future__ import annotations

import enum

import torch

from repro_torch.core import dsc as dsc_mod
from repro_torch.core.dsc import QuantizedDSCParams


class Schedule(enum.Enum):
    V0_LAYER_BY_LAYER = "v0"
    V1_PIXEL_SEQUENTIAL = "v1"
    V2_INTER_STAGE = "v2"
    V3_INTRA_STAGE = "v3"


def run_block(x_q: torch.Tensor, p: QuantizedDSCParams, schedule: Schedule,
              **kw) -> torch.Tensor:
    if schedule is Schedule.V0_LAYER_BY_LAYER:
        return dsc_mod.dsc_block_reference(x_q, p)
    if schedule is Schedule.V3_INTRA_STAGE:
        return dsc_mod.dsc_block_fused_rowtile(x_q, p, **kw)
    if schedule in (Schedule.V1_PIXEL_SEQUENTIAL, Schedule.V2_INTER_STAGE):
        raise NotImplementedError(
            f"schedule {schedule.value} is not ported yet: ROADMAP.md Queue 1, "
            "'v1/v2 schedules, core/traffic.py and the fusion cycle model'")
    raise ValueError(schedule)
