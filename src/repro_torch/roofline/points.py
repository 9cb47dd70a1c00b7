"""Shared roofline-point model + renderer.

One dataclass and one table formatter for the port's roofline views: the
CFU bottleneck doctor (``repro_torch.cfu.doctor.roofline_point``) emits its
points through here, so the CLI and its JSON payload print the same table
as the reference's ``repro.roofline.points``.

A :class:`RooflinePoint` is one kernel/configuration plotted against a
set of NAMED ceilings (ops/cycle each): the compute array's peak rate and
one ceiling per memory port (``arithmetic intensity x port bandwidth``,
the classic slanted roof evaluated at this point's intensity). The roof
is the minimum ceiling; the point is bound by whichever resource owns it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class RooflinePoint:
    """One configuration on a roofline plot.

    ``ops`` is the work the point executes (MACs for the CFU, FLOPs for
    the TPU views), ``cycles`` its achieved duration, ``ceilings`` the
    ops-per-cycle limit of each named resource *evaluated at this point*
    (for a memory port that is ``intensity(port) * port_bytes_per_cycle``;
    the caller prices it because the port model is theirs).
    ``bytes_by_port`` optionally records the traffic behind each port
    ceiling so the table can show arithmetic intensity.
    """

    name: str
    ops: float
    cycles: float
    ceilings: Mapping[str, float]
    bytes_by_port: Mapping[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def achieved(self) -> float:
        """Ops per cycle this point actually sustained."""
        return self.ops / self.cycles if self.cycles else 0.0

    @property
    def roof(self) -> float:
        """The binding ceiling (minimum over resources)."""
        finite = [c for c in self.ceilings.values() if c == c]  # drop NaN
        return min(finite) if finite else float("inf")

    @property
    def bound(self) -> str:
        """Name of the resource that owns the roof (first minimum in
        insertion order — deterministic)."""
        if not self.ceilings:
            return "unbounded"
        return min(self.ceilings, key=lambda k: self.ceilings[k])

    @property
    def utilization(self) -> float:
        """Achieved / roof (0 when the roof is unbounded)."""
        r = self.roof
        return self.achieved / r if r and r != float("inf") else 0.0

    def intensity(self, port: str) -> float:
        """Arithmetic intensity against one port (ops per byte)."""
        b = self.bytes_by_port.get(port, 0.0)
        return self.ops / b if b else float("inf")

    def to_json(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "ops": self.ops,
            "cycles": self.cycles,
            "achieved_ops_per_cycle": self.achieved,
            "ceilings": dict(self.ceilings),
            "bytes_by_port": dict(self.bytes_by_port),
            "intensity": {p: self.intensity(p) for p in self.bytes_by_port},
            "roof": self.roof,
            "bound": self.bound,
            "utilization": self.utilization,
        }


def _fmt(x: float, spec: str = ".3g") -> str:
    if x != x:
        return "nan"
    if x == float("inf"):
        return "inf"
    return format(x, spec)


def points_table(points: Sequence[RooflinePoint], *,
                 ops_unit: str = "MACs") -> List[str]:
    """Render points as the repo's CSV-ish table lines (comment header
    first, the convention of the repo's CSV-ish reports)."""
    ports: List[str] = []
    for p in points:
        for k in p.ceilings:
            if k not in ports:
                ports.append(k)
    head = [f"ceil[{k}]" for k in ports]
    out = [f"# roofline: achieved {ops_unit}/cycle vs named ceilings "
           f"(roof = min; bound = its owner)",
           ",".join(["name", f"achieved_{ops_unit}/cyc"] + head
                    + ["roof", "bound", "util"])]
    for p in points:
        cols = [p.name, _fmt(p.achieved)]
        cols += [_fmt(p.ceilings[k]) if k in p.ceilings else "-"
                 for k in ports]
        cols += [_fmt(p.roof), p.bound, _fmt(p.utilization, ".1%")]
        out.append(",".join(cols))
    return out


def points_json(points: Sequence[RooflinePoint]) -> List[Dict[str, object]]:
    """JSON rows of :meth:`RooflinePoint.to_json` (artifact payload)."""
    return [p.to_json() for p in points]
