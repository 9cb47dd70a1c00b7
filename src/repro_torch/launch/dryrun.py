"""Multi-pod dry run (port of ``repro.launch.dryrun``).

For every (architecture x input shape) cell, build the production mesh
over a ``fake`` process group (one process standing for rank 0 of 256 or
512), run the cell's step once on fake tensors (``FakeTensorMode``: full
width and depth, shapes only, no data and no device memory) under
``roofline.op_cost.OpCostMode``, and record:

  * the per-device argument bytes, exact from the local shards, and a
    peak-live estimate of what the step allocates on top of them; ``fits``
    says whether the two together stay within ``HW_H100``'s HBM (a cell
    that runs but does not fit has ``status`` "ok" and ``fits`` false);
  * FLOPs, bytes and collective wire bytes per device, for the roofline
    on ``HW_H100`` (``roofline.analysis``).

The step is the one a card would run: the flash and FFN launches are the
custom ops ``repro_torch::flash_attention`` and ``::fused_ffn``, whose fake
impls refuse what the launchers refuse before they touch the card and give
shapes, and whose flop formulas count the kernels' own work. The
fake tensors are ``cuda`` tensors where torch is built with CUDA; a
CPU-only build cannot run autograd on fake ``cuda`` tensors, and there the
fake tensors are on the CPU and take the same kernel route
(``kernels.fused_dsc.on_card``). A train cell runs its first microbatch and
counts it once per microbatch (``op_cost.trips``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k \\
      --mesh single                       # one cell
  python -m repro_torch.launch.dryrun --all --mesh both        # grid
  python -m repro_torch.launch.dryrun --all --arch glm4-9b   # one arch
  python -m repro_torch.launch.dryrun --list    # enumerate cells
  python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k \\
      --mesh single --breakdown   # + top FLOPs, bytes, live at the peak

Results are written as JSON to
results/dryrun_torch/<arch>__<shape>__<mesh>.json (one file per cell, the
reference's keys; ``python -m repro_torch.roofline.report`` tabulates
them).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.launch.mesh import fake_process_group, make_production_mesh
from repro_torch.models import lm
from repro_torch.roofline import breakdown
from repro_torch.roofline.analysis import (HW_H100, roofline_from_cost,
                                           summarize)
from repro_torch.roofline.op_cost import OpCostMode
from repro_torch.runtime import steps as steps_mod

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def fake_device_type() -> str:
    """The device of the dry run's fake tensors (module docstring)."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _local_bytes(x) -> int:
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in tree.leaves(x)
               if isinstance(t, torch.Tensor))


def _fake_leaves(abstract, device):
    """Empty tensors of ``abstract``'s shapes and dtypes on ``device`` (fake
    under the caller's ``FakeTensorMode``)."""
    return tree.map_leaves(
        lambda a: torch.empty(a.shape, dtype=a.dtype, device=device),
        abstract)


def lower_cell(cfg, shape, mesh, device):
    """Run one cell's step on fake inputs under a fresh ``OpCostMode``:
    (the mode, the per-device argument bytes, the output)."""
    if shape.kind == "train":
        train = steps_mod.TrainSpec(
            grad_compression="pod" in mesh.mesh_dim_names)
        params = _fake_leaves(lm.abstract_params(cfg, torch.float32), device)
        state = steps_mod.shard_train_state(
            steps_mod.train_state(params, train), mesh, cfg, train)
        batch = steps_mod.shard_batch(
            cfg, mesh, steps_mod.abstract_batch(cfg, shape, device))
        step = steps_mod.build_train_step(cfg, train, shape, mesh=mesh,
                                          count_one_micro=True)
        args = _local_bytes(state) + _local_bytes(batch)
        with OpCostMode() as mode:
            out = step(state, batch)
        return mode, args, out
    params = steps_mod.shard_params(
        _fake_leaves(lm.abstract_params(cfg, torch.bfloat16), device), mesh)
    if shape.kind == "prefill":
        batch = steps_mod.shard_batch(
            cfg, mesh, steps_mod.abstract_batch(cfg, shape, device))
        build = (steps_mod.build_prefill_step if cfg.causal
                 else steps_mod.build_encode_step)   # encoder-only: no cache
        step = build(cfg, mesh, shape)
        args = _local_bytes(params) + _local_bytes(batch)
        with OpCostMode() as mode:
            out = step(params, batch)
        return mode, args, out
    if shape.kind == "decode":
        cache = lm.sharded_cache(cfg, shape.global_batch, shape.seq_len, mesh)
        _, token, pos = steps_mod.decode_inputs(cfg, shape, device)
        token = steps_mod.shard_batch(cfg, mesh, {"token": token})["token"]
        step = steps_mod.build_decode_step(cfg, mesh, shape)
        args = _local_bytes(params) + _local_bytes(cache) + \
            _local_bytes(token)
        with OpCostMode() as mode:
            out = step(params, cache, token, pos)
        return mode, args, out
    raise ValueError(shape.kind)


def model_flops(cfg, shape) -> float:
    """2 N_active per token forward, 6 N_active with the backward."""
    if shape.kind == "train":
        return 6.0 * cfg.active_param_count() * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * cfg.active_param_count() * shape.tokens
    return 2.0 * cfg.active_param_count() * shape.global_batch


def run_cell(arch: str, shape_name: str, mesh_name: str,
             out_dir: str = RESULTS_DIR, verbose: bool = True,
             cfg_override=None, show_breakdown: bool = False
             ) -> Optional[dict]:
    cell = registry.cell_for(arch, SHAPES_BY_NAME[shape_name])
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
    if not cell.runnable:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "n/a", "reason": cell.skip_reason}
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=2)
        if verbose:
            print(f"[dryrun] {cell.key} N/A: {cell.skip_reason}")
        return rec

    # the hand kernels, as launch.serve and launch.train run them by default
    cfg = dataclasses.replace(cfg_override or registry.get(arch),
                              attn_impl="kernel", block_impl="fused")
    shape = SHAPES_BY_NAME[shape_name]
    multi = mesh_name == "multi"
    chips = 512 if multi else 256
    dev = fake_device_type()
    t0 = time.time()
    try:
        with fake_process_group(chips):
            mesh = make_production_mesh(multi_pod=multi, device_type=dev)
            with FakeTensorMode():
                mode, arg_bytes, out = lower_cell(cfg, shape, mesh,
                                                  torch.device(dev))
            t_run = time.time() - t0
            out_bytes = _local_bytes(out)
            rep = roofline_from_cost(
                mode, arch=arch, shape=shape_name, mesh_name=mesh_name,
                chips=chips, model_flops=model_flops(cfg, shape), mesh=mesh,
                peak_memory_bytes=float(arg_bytes + mode.peak_live_bytes))
        rec = rep.as_dict()
        live = arg_bytes + mode.peak_live_bytes
        rec.update({
            "status": "ok",
            # arguments plus the live estimate within one card's HBM
            "fits": live <= HW_H100["hbm_bytes"],
            "lower_s": t_run, "compile_s": 0.0,
            "memory": {
                "argument_bytes": arg_bytes,
                "output_bytes": out_bytes,
                # what the step allocated at its peak, on top of its
                # arguments: an estimate from op outputs' lifetimes
                "temp_bytes": mode.peak_live_bytes,
                "temp_is_estimate": True,
                "alias_bytes": None,
                "generated_code_bytes": None,
            },
            "fake_device": dev,
        })
        if verbose:
            print(f"[dryrun] {cell.key} mesh={mesh_name} OK ({t_run:.0f}s)")
            print("         " + summarize(rep))
            print(f"         mem/device: args={arg_bytes / 2**30:.2f} GiB "
                  f"temp~{mode.peak_live_bytes / 2**30:.2f} GiB"
                  + ("" if rec["fits"] else
                     f" DOES NOT FIT in {HW_H100['hbm_bytes'] / 2**30:.1f}"
                     f" GiB"))
        if show_breakdown:
            breakdown.print_top(mode)
    except Exception as e:                            # noqa: BLE001
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "error", "error": repr(e),
               "traceback": traceback.format_exc()}
        if verbose:
            print(f"[dryrun] {cell.key} mesh={mesh_name} FAILED: {e!r}")
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=2, default=str)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=registry.ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES_BY_NAME))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true",
                    help="every cell (of --arch, where given)")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--breakdown", action="store_true",
                    help="print each cell's top FLOP, byte and collective "
                         "contributors and what was live at its peak")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells whose result JSON already exists and is ok")
    args = ap.parse_args(argv)

    if args.list:
        for c in registry.cells():
            print(f"{c.key:45s} {'RUN' if c.runnable else 'N/A: ' + str(c.skip_reason)}")
        return 0

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        todo = [(c.arch, c.shape.name, m)
                for c in registry.cells() for m in meshes
                if args.arch in (None, c.arch)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all, required")
        todo = [(args.arch, args.shape, m) for m in meshes]

    failed = 0
    for arch, shp, m in todo:
        out_path = os.path.join(args.out, f"{arch}__{shp}__{m}.json")
        if args.skip_done and os.path.exists(out_path):
            with open(out_path) as f:
                if json.load(f).get("status") in ("ok", "n/a"):
                    print(f"[dryrun] {arch}/{shp}/{m} cached, skipping")
                    continue
        rec = run_cell(arch, shp, m, out_dir=args.out,
                       show_breakdown=args.breakdown)
        failed += rec.get("status") == "error"
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
