"""Aggregate the port's dry-run JSONs into the roofline table (markdown;
port of ``repro.roofline.report``, the same layout and schema), then the
per-device budget of every cell (``budget_table``).

    PYTHONPATH=src python -m repro_torch.roofline.report \
        [--dir results/dryrun_torch]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(d: str) -> List[Dict]:
    out = []
    for f in sorted(os.listdir(d)):
        if f.endswith(".json"):
            with open(os.path.join(d, f)) as fh:
                out.append(json.load(fh))
    return out


def fmt_s(x) -> str:
    if x is None:
        return "-"
    if x >= 1.0:
        return f"{x:.2f}s"
    return f"{x * 1e3:.2f}ms"


def table(records: List[Dict], mesh: str) -> str:
    rows = [r for r in records if r.get("mesh") == mesh or
            (r.get("status") == "n/a" and r.get("mesh") == mesh)]
    rows.sort(key=lambda r: (r["arch"], ORDER.index(r["shape"])
                             if r["shape"] in ORDER else 9))
    lines = [
        "| arch | shape | compute | memory | collective | bound | "
        "MFU* | useful | mem/dev (args+temp) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("status") == "n/a":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | N/A |"
                         f" — | — | {r['reason']} |")
            continue
        if r.get("status") != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR: "
                         f"{r.get('error', '?')} | | | | | | |")
            continue
        mem = r.get("memory", {})
        args_gib = (mem.get("argument_bytes") or 0) / 2 ** 30
        temp_gib = (mem.get("temp_bytes") or 0) / 2 ** 30
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['t_compute'])} | "
            f"{fmt_s(r['t_memory'])} | {fmt_s(r['t_collective'])} | "
            f"{r['bottleneck']} | {r['mfu_proxy'] * 100:.1f}% | "
            f"{r['useful_flops_frac'] * 100:.1f}% | "
            f"{args_gib:.2f}+{temp_gib:.2f} GiB |")
    return "\n".join(lines)


def budget_table(records: List[Dict]) -> str:
    """Every ok cell, one row per (arch, shape) with the single / multi
    meshes side by side: per-device argument bytes and the step's
    peak-live estimate, whether the two fit in one card's HBM, FLOPs per
    device, and the binding term with its seconds."""
    cells: Dict = {}
    for r in records:
        if r.get("status") == "ok":
            cells.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r

    def pair(by_mesh, fn):
        return " / ".join(fn(by_mesh[m]) if m in by_mesh else "-"
                          for m in ("single", "multi"))

    def bound(r):
        t = {"compute": r["t_compute"], "memory": r["t_memory"],
             "collective": r["t_collective"]}[r["bottleneck"]]
        return f"{r['bottleneck']} {t:.4g}"

    def gib(key):
        return lambda r: f"{r['memory'][key] / 2 ** 30:.2f}"

    lines = ["| arch | shape | args GiB | live~ GiB | fits | FLOPs/dev | "
             "bound, s |", "|---|---|---|---|---|---|---|"]
    for (arch, shape), by_mesh in sorted(cells.items(), key=lambda kv: (
            kv[0][0], ORDER.index(kv[0][1]) if kv[0][1] in ORDER else 9)):
        cols = [pair(by_mesh, gib("argument_bytes")),
                pair(by_mesh, gib("temp_bytes")),
                pair(by_mesh, lambda r: "yes" if r.get("fits") else "NO"),
                pair(by_mesh, lambda r: f"{r['hlo_flops']:.3e}"),
                pair(by_mesh, bound)]
        lines.append(f"| {arch} | {shape} | " + " | ".join(cols) + " |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "results",
        "dryrun_torch"))
    args = ap.parse_args()
    recs = load(args.dir)
    for mesh in ("single", "multi"):
        n_ok = sum(1 for r in recs if r.get("mesh") == mesh
                   and r.get("status") == "ok")
        print(f"\n## mesh = {mesh} ({n_ok} cells compiled)\n")
        print(table(recs, mesh))
    print("\n## per-device budget, single / multi\n")
    print(budget_table(recs))


if __name__ == "__main__":
    main()
