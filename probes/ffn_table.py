#!/usr/bin/env python3
"""Time the fused-FFN kernel at every shape of PERF.md's kernel table, for
one checkout, and compare two checkouts' outputs bit for bit.

    python3 probes/ffn_table.py time TREE --tag NAME [--out DIR] [--rows A,B]
    python3 probes/ffn_table.py compare DIR NAME_A NAME_B

``time``: TREE is the root of a checkout; its ``src`` is the package
imported (its kernels built into its own ``build/``), so two commits are
compared by running ``time`` once per tree within one call, in the order
A, B, B, A. For each row, seeded bf16 inputs (the same on every tree) go
through ``ops.ffn``; the row prints one JSON line: the plan (d_model
slices, cluster, columns per block, d_ff groups), the resident clusters,
the kernel's CUDA-graph time and the bound max(operations / 989 TFLOP/s,
weight and activation bytes / 3.35 TB/s) and their ratio, both as
``chip_smoke.py`` takes them (its ``time_ms`` with 10 calls a graph and 3
replays, as its table's rows; its ``ffn_bound``). The inputs are the
probe's own seeded draws, not ``chip_smoke.py``'s, which also times the
plain version and the unfused chain. The outputs go to
``DIR/NAME/<row>.pt``. ``--rows`` keeps the rows named (every row by
default).

``compare``: for each row both trees wrote, whether the outputs are equal
bit for bit, and their largest absolute difference.

The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (row, T, d_model, d_ff, gated, act): PERF.md's kernel table, and the
# glm4-9b and trinity-mini cells' launches (prefill 1500, a decode_b16
# batch's prefill of 16 x 1020 and its T 16 steps; trinity's dense lead
# layers and shared expert at 8192)
ROWS = [
    ("gemma2-9b.T2048", 2048, 3584, 14336, True, "gelu"),
    ("gemma2-9b.T4", 4, 3584, 14336, True, "gelu"),
    ("glm4-9b.T2048", 2048, 4096, 13696, True, "silu"),
    ("glm4-9b.T4", 4, 4096, 13696, True, "silu"),
    ("glm4-9b.T1500", 1500, 4096, 13696, True, "silu"),
    ("glm4-9b.T16", 16, 4096, 13696, True, "silu"),
    ("glm4-9b.T16320", 16320, 4096, 13696, True, "silu"),
    ("glm4-9b.T1000", 1000, 4096, 13696, True, "silu"),
    ("qwen3-14b.T2048", 2048, 5120, 17408, True, "silu"),
    ("qwen3-14b.T4", 4, 5120, 17408, True, "silu"),
    ("qwen2-72b.T2048", 2048, 8192, 29568, True, "silu"),
    ("qwen2-72b.T4", 4, 8192, 29568, True, "silu"),
    ("internvl2-1b.T3072", 3072, 896, 4864, True, "silu"),
    ("internvl2-1b.T4", 4, 896, 4864, True, "silu"),
    ("hubert-xlarge.T2048", 2048, 1280, 5120, False, "gelu"),
    ("qwen2-moe-shared.T2048", 2048, 2048, 5632, True, "silu"),
    ("qwen2-moe-shared.T4", 4, 2048, 5632, True, "silu"),
    ("llama4-shared.T2048", 2048, 5120, 8192, True, "silu"),
    ("llama4-shared.T4", 4, 5120, 8192, True, "silu"),
    ("recurrentgemma-9b.T2048", 2048, 4096, 12288, True, "gelu"),
    ("recurrentgemma-9b.T4", 4, 4096, 12288, True, "gelu"),
    ("rwkv6-3b.T2048", 2048, 2560, 8960, False, "relu_sq"),
    ("rwkv6-3b.T4", 4, 2560, 8960, False, "relu_sq"),
    ("trinity-mini-lead.T8192", 8192, 2048, 6144, True, "silu"),
    ("trinity-mini-shared.T8192", 8192, 2048, 1024, True, "silu"),
]


def run_time(tree: Path, tag: str, out: Path, rows=None) -> int:
    sys.path.insert(0, str(tree.resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("ffn_table: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import fused_ffn, ops
    import repro_torch
    # chip_smoke imports the package already loaded, TREE's
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    where = Path(repro_torch.__file__).resolve().parents[2]
    print(f"# {tag}: {where}; card {chip_smoke.card_line()}", flush=True)
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    save = out / tag
    save.mkdir(parents=True, exist_ok=True)
    for i, (row, t, d, f, gated, act) in enumerate(ROWS):
        if rows and row not in rows:
            continue
        gen = torch.Generator(device=dev).manual_seed(1000 + i)

        def draw(shape, scale):
            return (torch.randn(shape, generator=gen, device=dev)
                    * scale).bfloat16()
        x = draw((t, d), 1.0)
        wg = draw((d, f), d ** -0.5) if gated else None
        wu = draw((d, f), d ** -0.5)
        wd = draw((f, d), f ** -0.5)
        y = ops.ffn(x, wg, wu, wd, act=act)
        torch.cuda.synchronize()
        torch.save(y.cpu(), save / f"{row}.pt")
        ms = chip_smoke.time_ms(lambda: ops.ffn(x, wg, wu, wd, act=act), 10, 3)
        resident = fused_ffn.max_active_clusters(t, d, f, n_sm)
        # what the launch ran: a checkout whose plan reads no residency
        # plans without it
        try:
            pl = fused_ffn.plan(t, d, f, torch.bfloat16, n_sm, resident)
        except TypeError:
            pl = fused_ffn.plan(t, d, f, torch.bfloat16, n_sm)
        flops, moved = chip_smoke.ffn_bound(t, d, f, gated=gated)
        b = max(flops / chip_smoke.PEAK_BF16_FLOPS,
                moved / chip_smoke.PEAK_HBM_BYTES) * 1e3
        print(json.dumps({
            "tree": tag, "row": row, "T": t, "d": d, "d_ff": f,
            "slices": pl.slices, "cluster": pl.cluster, "cols": pl.cols,
            "groups": pl.groups, "grid": list(pl.grid),
            "resident_clusters": resident, "kernel_ms": round(ms, 6),
            "bound_ms": round(b, 6), "roofline_pct": round(100 * b / ms, 3)}),
            flush=True)
        del x, wg, wu, wd, y
        torch.cuda.empty_cache()
    return 0


def run_compare(out: Path, a: str, b: str) -> int:
    import torch
    for row, *_ in ROWS:
        pa, pb = out / a / f"{row}.pt", out / b / f"{row}.pt"
        if not (pa.exists() and pb.exists()):
            continue
        ya, yb = torch.load(pa), torch.load(pb)
        diff = (ya.float() - yb.float()).abs().max().item()
        print(json.dumps({"row": row, "bit_equal": bool(torch.equal(ya, yb)),
                          "max_abs_diff": diff}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("time")
    t.add_argument("tree", type=Path)
    t.add_argument("--tag", required=True)
    t.add_argument("--out", type=Path, default=Path("build/ffn_table"))
    t.add_argument("--rows", type=lambda v: v.split(","), default=None)
    c = sub.add_parser("compare")
    c.add_argument("out", type=Path)
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "time":
        return run_time(args.tree, args.tag, args.out, args.rows)
    return run_compare(args.out, args.a, args.b)


if __name__ == "__main__":
    sys.exit(main())
