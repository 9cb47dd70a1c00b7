"""Roofline tooling for the port: ``points`` (the CFU doctor's views),
``op_cost`` (per-device cost of a step, op by op), ``analysis`` (the
three-term roofline on the H100's rates), ``breakdown`` and ``report``."""

from repro_torch.roofline.points import (  # noqa: F401
    RooflinePoint, points_json, points_table)
