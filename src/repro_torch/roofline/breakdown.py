"""Per-op cost attribution (port of ``repro.roofline.breakdown``).

The perf loop needs to know *which ops* dominate each roofline term.
``OpCostMode`` keeps a per-op ledger (scaled by ``trips``), keyed by op
and result shape so that repeated instances aggregate; ``breakdown``
returns it by category and ``print_top`` shows the top contributors, and
beside them what was live at the step's memory peak (``peak_live_by``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Tuple

from repro_torch.roofline.analysis import wire_bytes


def breakdown(mode) -> Tuple[Dict[str, float], Dict[str, float],
                             Dict[str, float], Dict[str, float]]:
    """(flops by op, bytes by op, collective wire bytes by op, collective
    counts by op), per device."""
    coll_by: Dict[str, float] = defaultdict(float)
    coll_cnt: Dict[str, float] = defaultdict(float)
    for r in mode.collectives:
        key = f"{r.kind} {r.out_bytes} B over {r.group_size}"
        coll_by[key] += r.times * wire_bytes(r.kind, r.in_bytes, r.out_bytes,
                                             r.group_size)
        coll_cnt[key] += r.times
    return dict(mode.flops_by), dict(mode.bytes_by), dict(coll_by), \
        dict(coll_cnt)


def top(mode, k: int = 15) -> Dict[str, list]:
    """The ``k`` largest entries of each ledger, largest first."""
    flops_by, bytes_by, coll_by, coll_cnt = breakdown(mode)
    pick = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:k]  # noqa: E731
    live = mode.peak_live_by
    return {"flops": pick(flops_by), "bytes": pick(bytes_by),
            "collectives": [(key, v, coll_cnt[key]) for key, v in
                            pick(coll_by)],
            "live": [(key, b, live[key][1]) for key, b in
                     pick({k: b for k, (b, _) in live.items()})]}


def print_top(mode, k: int = 15) -> None:
    t = top(mode, k)
    print(f"== top {k} FLOP contributors (per device) ==")
    for key, v in t["flops"]:
        print(f"  {v:12.4e}  {key}")
    print(f"== top {k} BYTE contributors (per device) ==")
    for key, v in t["bytes"]:
        print(f"  {v / 2**30:10.2f}GiB  {key}")
    print(f"== top {k} collectives (wire bytes per device) ==")
    for key, v, n in t["collectives"]:
        print(f"  {v / 2**30:10.2f}GiB x{n:7.0f}  {key}")
    print(f"== top {k} live at the peak of "
          f"{mode.peak_live_bytes / 2**30:.2f} GiB (per device) ==")
    for key, v, n in t["live"]:
        print(f"  {v / 2**30:10.2f}GiB x{n:7d}  {key}")
