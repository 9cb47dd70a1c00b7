"""Roofline points for the port (``points``). The reference's HLO roofline
(``repro.roofline.analysis``) has no counterpart yet."""

from repro_torch.roofline.points import (  # noqa: F401
    RooflinePoint, points_json, points_table)
