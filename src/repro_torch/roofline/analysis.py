"""Three-term roofline of one step on a mesh (port of
``repro.roofline.analysis``).

    compute    = FLOPs / peak_FLOP/s
    memory     = bytes / HBM_bw
    collective = sum over collectives of wire bytes / the link they cross

All quantities are per device (``op_cost`` counts each op at its local
shape). Wire bytes follow the ring model, per collective of group size g:

    all-gather        (g-1)/g x result_bytes
    reduce-scatter    (g-1)/g x operand_bytes
    all-reduce        2 (g-1)/g x operand_bytes
    all-to-all        (g-1)/g x operand_bytes

The collectives come from the ``OpCostMode`` records (the functional
collectives DTensor issues, seen as ``CommDebugMode`` sees them).

``HW_H100`` holds one card's rates, and the link a collective is charged
depends on its group: an H100 host holds 8 GPUs in one NVLink domain, so a
group inside one host moves over NVLink and a group across hosts over each
GPU's InfiniBand port. The production mesh's ``model`` axis of 16 spans
two hosts, so it is charged InfiniBand; the report names the link of every
axis it charged (``links``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

# One NVIDIA H100 SXM5 80GB ("NVIDIA H100 80GB HBM3, 700 W" as nvidia-smi
# names the card), dense rates at the full 700 W power limit. Sources:
# NVIDIA H100 Tensor Core GPU data sheet (bf16 989 TFLOP/s dense, HBM3
# 3.35 TB/s, 80 GB, NVLink 900 GB/s both directions = 450 GB/s each way);
# NVIDIA DGX H100 user guide (8 GPUs per NVLink domain, one ConnectX-7
# 400 Gb/s InfiniBand port per GPU = 50 GB/s each way).
HW_H100 = {
    "card": "NVIDIA H100 80GB HBM3, 700 W",
    "peak_flops_bf16": 989e12,   # FLOP/s
    "hbm_bw": 3.35e12,           # B/s
    "hbm_bytes": 80e9,
    "nvlink_bw": 450e9,          # B/s each way, per GPU, inside a host
    "ib_bw": 50e9,               # B/s each way, per GPU, across hosts
    "gpus_per_host": 8,
}


def wire_bytes(kind: str, in_bytes: float, out_bytes: float,
               g: int) -> float:
    """Bytes one device sends for one collective (ring model)."""
    frac = (g - 1) / g if g > 1 else 0.0
    if kind == "all-gather":
        return frac * out_bytes
    if kind == "all-reduce":
        return 2.0 * frac * in_bytes
    if kind in ("reduce-scatter", "all-to-all"):
        return frac * in_bytes
    return float(in_bytes)                       # collective-permute


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    wire_bytes: Dict[str, float]          # per device, per op kind

    @property
    def total_bytes(self) -> float:
        return sum(self.wire_bytes.values())


def collective_stats(records: Iterable) -> CollectiveStats:
    """Counts and wire bytes by kind from ``op_cost.CollectiveRecord``s."""
    counts: Dict[str, int] = {}
    wire: Dict[str, float] = {}
    for r in records:
        b = wire_bytes(r.kind, r.in_bytes, r.out_bytes, r.group_size)
        counts[r.kind] = counts.get(r.kind, 0) + int(r.times)
        wire[r.kind] = wire.get(r.kind, 0.0) + b * r.times
    return CollectiveStats(counts=counts, wire_bytes=wire)


def link_of(ranks: List[int], hw: Dict = HW_H100) -> str:
    """"nvlink" for a group inside one host, else "ib"."""
    return ("nvlink" if len({r // hw["gpus_per_host"] for r in ranks}) <= 1
            else "ib")


def mesh_links(mesh, hw: Dict = HW_H100) -> Dict[str, str]:
    """{axis: link} for this rank's group on each mesh axis."""
    import torch.distributed as dist
    return {name: link_of(dist.get_process_group_ranks(mesh.get_group(name)),
                          hw)
            for name in mesh.mesh_dim_names}


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # raw quantities (per device)
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collective_counts: Dict[str, int]
    peak_memory_bytes: Optional[float]
    # terms (seconds)
    t_compute: float
    t_memory: float
    t_collective: float
    # analytics
    model_flops: float                    # 6*N_active*tokens (global)
    useful_flops_frac: float              # model / (flops * chips)
    bottleneck: str
    t_model: float = 0.0                  # model_flops / (chips x peak)
    mfu_proxy: float = 0.0                # t_model / max(terms)
    # the port's additions: which link each axis was charged, the wire
    # bytes per link, and the card the constants describe
    links: Dict[str, str] = dataclasses.field(default_factory=dict)
    collective_bytes_by_link: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    hardware: str = HW_H100["card"]

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def roofline_from_cost(mode, *, arch: str, shape: str, mesh_name: str,
                       chips: int, model_flops: float, mesh=None,
                       hw: Dict = HW_H100,
                       peak_memory_bytes: Optional[float] = None
                       ) -> RooflineReport:
    """The report of what an ``op_cost.OpCostMode`` counted for one step
    on ``mesh`` (each collective charged to the link its group crosses)."""
    import torch.distributed as dist
    cost = mode.cost()
    stats = collective_stats(mode.collectives)
    by_link: Dict[str, float] = {}
    for r in mode.collectives:
        link = "nvlink"
        if dist.is_initialized():
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            link = link_of(dist.get_process_group_ranks(
                _resolve_process_group(r.group_name)), hw)
        b = wire_bytes(r.kind, r.in_bytes, r.out_bytes, r.group_size)
        by_link[link] = by_link.get(link, 0.0) + b * r.times
    t_c = cost.flops / hw["peak_flops_bf16"]
    t_m = cost.bytes / hw["hbm_bw"]
    t_x = sum(b / hw[f"{link}_bw"] for link, b in by_link.items())
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    t_model = model_flops / (chips * hw["peak_flops_bf16"])
    t_max = max(terms.values())
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=cost.flops, hlo_bytes=cost.bytes,
        collective_bytes=stats.total_bytes,
        collective_counts=stats.counts,
        peak_memory_bytes=peak_memory_bytes,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        model_flops=model_flops,
        useful_flops_frac=(model_flops / (cost.flops * chips)
                           if cost.flops > 0 else 0.0),
        bottleneck=max(terms, key=terms.get),
        t_model=t_model,
        mfu_proxy=(t_model / t_max) if t_max > 0 else 0.0,
        links=mesh_links(mesh, hw) if mesh is not None else {},
        collective_bytes_by_link=by_link, hardware=hw["card"])


def summarize(r: RooflineReport) -> str:
    return (f"{r.arch:24s} {r.shape:12s} {r.mesh:9s} "
            f"C={r.t_compute * 1e3:9.3f}ms "
            f"M={r.t_memory * 1e3:9.3f}ms "
            f"X={r.t_collective * 1e3:9.3f}ms "
            f"bound={r.bottleneck:10s} "
            f"MFU*={r.mfu_proxy:6.1%} "
            f"useful={r.useful_flops_frac:6.1%}")
