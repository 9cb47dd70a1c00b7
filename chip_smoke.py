#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's three paths and fails (non-zero exit, no result line) on
any error: int8 MobileNetV2-VWW inference through the hand-written fused DSC
kernel, the same network compiled for the CFU and run by the CFU fast path
(whose fused and row-tile stages launch the same kernel), and gemma2-9b
serving (prefill + greedy decode) through the hand-written flash-attention
and fused-FFN kernels. Phases:

1. the card's name and power limit (nvidia-smi); no CUDA device -> fail;
2. build every kernel from src/repro_torch/kernels/csrc (one nvcc each, all
   at once) and print the build time and the ptxas register/smem lines,
   with each flash and FFN kernel's registers and spill line on one line;
   the bf16 flash launcher's shared memory must equal
   ``flash_attention.plan``, and the FFN launcher's plan (cluster, columns,
   chunk, ring stages, d_ff groups, shared memory, grid, workspace) must
   equal ``fused_ffn.plan`` at the serve path's and the checks' shapes;
   the DSC kernel's registers and spill line, the count of IMMA (int8
   tensor-core) instructions in its SASS where the toolkit has
   ``cuobjdump``, and its launcher's ``fused_dsc_plan`` (tile rows, units,
   grid, shared memory, padded K, ...) must equal ``fused_dsc.plan`` for the
   seven blocks at batch 1 and 256, with the card's occupancy at least the
   plan's blocks per SM;
3. DSC kernel vs plain version: ``fused_dsc_cuda`` must equal
   ``ref.fused_dsc_ref`` on the card and on the CPU (``torch.equal``) for the
   seven blocks of the 80x80 network at batch 1 and 256 (the plan's tiles)
   and at batch 64 (4-row tiles and the plan's), the eight ragged shapes of
   tests/test_kernels.py and one block with a non-zero float expansion bias;
4. DSC end to end: the seed-0 80x80 network on 256 and on 1 seeded images
   through ``forward_batch(use_kernel=True)`` on the card; its int8 logits
   and every int8 stage must equal the plain v0 forward on the CPU, and the
   launch count must grow by 7 per forward;
5. DSC serve: ``launch.serve.main(["--mobilenet", "--batch", "256"])``;
6. per DSC block at batch 256 and at batch 1: kernel time (CUDA events,
   warm L2 as in the forward), plain-version time, and the bound
   max(ops / 1,979 TOP/s, bytes / 3.35 TB/s);
7. where a forward's time goes at batch 1 and 256: host-clock latency and
   the device time torch.profiler records;
8. CFU compile: the 80x80 network through the port's compiler under the
   five schedules and ``auto``, on 1 and 3 cores (streams); words per
   stream and fingerprint printed, the text assembly re-assembles to the
   same words;
9. CFU fast path vs golden model: for each (schedule, streams),
   ``cfu.fastpath.run_fast`` on the card at batch 4 must equal the port's
   golden executor (numpy) on the same images, with 7 DSC launches per call
   under fused and fused-rowtile, 3 under fused-winograd, 0 under the layer
   schedules and one per fused or row-tile block under auto; the narrow
   chain of tests/test_cfu_fastpath.py (C 3, M 9) must be refused on the
   card with ``FastPathError``; at batch 256 on one core, every schedule's
   int8 logits must equal ``forward_batch(use_kernel=True)`` and the CPU
   fast path (the plain versions);
10. CFU entry point: ``launch.cfu.main(["--network", "vww", "--backend",
   "fast", "--batch", "256", "--schedule", "all"])``, every schedule
   verified;
11. CFU times at batch 1 and 256, with the card's name and power limit:
   host-clock ms per ``run_fast`` call (and per call of the executor it
   looks up) under fused and fused-rowtile and
   per ``forward_batch`` on the same weights, the device-busy ms
   torch.profiler records and the idle share; the seven DSC launches at the
   row-tile stream's tile rows and at the plan's (CUDA-graph time);
12. LM kernels vs plain versions: flash attention on the tests/test_kernels.py
   matrix (card and CPU) and at gemma2-9b's shapes (d 256, GQA 16/8,
   softcap 50, windows 4096, none and 64, ragged P) and at the wgmma
   kernel's edges (d 16 and 128, Tk < 64, Tq 65 / Tk 129 with window 48,
   B 2 P 509 unwindowed); the fused FFN on the
   tests/test_kernels.py sweep (card and CPU) and at gemma2-9b's widths,
   T 1, 4, 77, 1000, 2048; f32 within 2e-5, bf16 within 2e-2 elementwise
   and 1e-2 in relative norm; the f32 flash outputs are held on the CPU to
   the plain version computed in float64 and cast to float32;
13. LM end to end: full-width, full-depth gemma2-9b, seeded bf16 weights, B 4,
   P 512: one prefill and one decode step through the kernels, every kernel
   call held to its plain version on the same inputs, launches +42 flash and
   +42 FFN per prefill, +42 FFN per decode step; the bf16 drift between the
   kernel path, the kernels' plain versions and the plain disciplines
   (information); one pattern unit in float32, kernel vs reference
   disciplines, within 1e-3;
14. LM serve: ``launch.serve.main(["--arch", "gemma2-9b", "--batch", "4",
   "--prompt-len", "512", "--gen", "16"])``, whose tokens must equal a direct
   prefill/decode_step greedy loop with the same weights;
15. each LM kernel at its path shapes: CUDA-graph time, plain-version time,
   the bound max(flops / 989 TFLOP/s, bytes / 3.35 TB/s), and for flash
   attention the time of ``torch.compile(flex_attention)`` on the same
   inputs (the library yardstick, held to the plain version); flash again at
   a measurement shape off the serve path, B 1, P 4096 (the longest prompt
   a local layer's window covers), where the products bound it; for the
   FFN, its workspace (none at prefill, the d_ff groups' f32 partials at
   decode, < 1% of the weight bytes), the device kernels one call runs
   (one at prefill; the kernel and the groups' sum at decode), and the time
   of the unfused bf16 chain (three ``torch.matmul`` with h in device
   memory: a yardstick the port never calls, not one call of the same
   function);
16. where a prefill's and a decode step's time goes (torch.profiler).

The last stdout line is {"ok": true, "device": {...}}; the line before it is
the {"kernels": [...]} record, whose DSC rows also carry the kernel's
launches per fast-path call under each schedule.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.cfu import fastpath, isa  # noqa: E402
from repro_torch.cfu.compiler import (compile_network,  # noqa: E402
                                      compile_vww_network, schedule_names)
from repro_torch.cfu.executor import (run_multistream,  # noqa: E402
                                      run_program)
from repro_torch.cfu.network import (random_chain_params,  # noqa: E402
                                     vww_cfu_params)
from repro_torch.core import dsc, quant  # noqa: E402
from repro_torch.core.dsc import DSCBlockSpec as S  # noqa: E402
from repro_torch.core.fusion import Schedule  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import (build, flash_attention, fused_dsc,  # noqa: E402
                                 fused_ffn, ops, ref)
from repro_torch.launch import cfu as cfu_cli  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mobilenetv2 as mnv2  # noqa: E402

# H100 SXM published dense peaks (NVIDIA data sheet), at a 700 W limit.
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12
SOURCE = "src/repro_torch/kernels/csrc/fused_dsc.cu"
REPLACES = "src/repro/kernels/fused_dsc.py:59"


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def block_args(qp):
    """The kernel's tensor arguments and statics for one quantized block."""
    tensors = [qp.w_exp, qp.w_dw.reshape(9, qp.spec.cmid), qp.w_proj,
               qp.b_exp, qp.b_dw, qp.b_proj, qp.m_exp, qp.m_dw, qp.m_proj]
    statics = dict(stride=qp.spec.stride, zps=qp.zps, q6=(qp.q6_f1, qp.q6_f2))
    return tensors, statics


def block_maps(net):
    """The input map size of each of the 80x80 network's seven blocks."""
    hw, maps = 40, []   # 40: the stem output of an 80x80 image
    for qp in net.blocks:
        maps.append(hw)
        hw = qp.spec.out_hw(hw, hw)[0]
    return maps


def network_block_cases(net_cpu, batch: int, rng):
    """(name, x, block params) for the seven blocks at their 80x80-network
    input sizes, with seeded random int8 inputs."""
    return [(name, torch.from_numpy(rng.integers(
                -128, 128, (batch, hw, hw, qp.spec.cin), np.int8)), qp)
            for (name, *_), qp, hw in zip(mnv2.PAPER_BLOCKS, net_cpu.blocks,
                                          block_maps(net_cpu))]


def ragged_block_cases(rng):
    """The eight shapes of tests/test_kernels.py and a non-zero float
    expansion bias, as (name, x, params, tile_rows)."""
    shapes = [(S(8, 48, 8, 1), 12, 4), (S(8, 48, 16, 2), 12, 3),
              (S(16, 96, 16, 1), 10, 2), (S(8, 24, 8, 1), 9, 5),
              (S(8, 24, 8, 1), 13, 4), (S(8, 24, 16, 2), 13, 4),
              (S(8, 24, 8, 2), 11, 4), (S(8, 24, 8, 1), 7, 16)]
    cases = []
    for i, (spec, hw, tile_rows) in enumerate(shapes + [shapes[3]]):
        p32 = dsc.init_dsc_block_f32(rng, spec)
        if i == len(shapes):   # the non-zero float b_exp case
            p32["b_exp"] = torch.from_numpy(
                rng.standard_normal(spec.cmid).astype(np.float32))
        calib = rng.standard_normal((hw, hw, spec.cin)).astype(np.float32)
        qp = dsc.quantize_dsc_block(p32, spec, calib)
        x = rng.integers(-128, 128, (4, hw, hw, spec.cin), np.int8)
        name = f"{spec.cin}x{spec.cmid}x{spec.cout}s{spec.stride}@{hw}"
        cases.append((name + ("+b_exp" if i == len(shapes) else ""),
                      torch.from_numpy(x), qp, tile_rows))
    return cases


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    check(bool(out), "nvidia-smi printed no card")
    return out


def phase_build():
    t0 = time.perf_counter()
    built = build.build_all()
    say(f"[build] {len(built)} kernel libraries in "
        f"{time.perf_counter() - t0:.2f} s")
    for b in built.values():
        say(f"[build] {b.path.name}: nvcc {b.seconds:.2f} s")
        for line in b.ptxas:
            say(f"[build]   {line}")
    for name in ("fused_dsc", "flash_attention", "fused_ffn"):
        check(name in built, f"{name} was not built")
    for lib in ("fused_dsc", "flash_attention", "fused_ffn"):
        for kernel, regs, spills in ptxas_kernels(built[lib].ptxas):
            say(f"[build] {lib} {kernel}: {regs} registers, {spills}")
            if lib == "fused_dsc":
                check("0 bytes spill stores" in spills,
                      f"fused_dsc {kernel} spills: {spills}")
    imma = sass_counts(built["fused_dsc"].path, "IMMA")
    if imma is None:
        say("[build] fused_dsc SASS: cuobjdump not found, IMMA not counted")
    else:
        say(f"[build] fused_dsc SASS: {imma} IMMA instructions per kernel")
        check(all(n > 0 for n in imma.values()),
              f"fused_dsc SASS has no IMMA instruction: {imma}")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    net = mnv2.init_and_quantize(0, img_hw=80, device="cpu")
    for batch in (1, 256):
        tiles = []
        for (name, *_), qp, hw in zip(mnv2.PAPER_BLOCKS, net.blocks,
                                      block_maps(net)):
            sp = qp.spec
            pl = fused_dsc.plan(batch, hw, hw, sp.cin, sp.cmid, sp.cout,
                                sp.stride, None, n_sm)
            check(fused_dsc.kernel_plan(batch, hw, hw, sp.cin, sp.cmid,
                                        sp.cout, sp.stride, None, n_sm)
                  == pl.as_tuple(),
                  f"dsc launcher plan != fused_dsc.plan: {name} B{batch}")
            occ = fused_dsc.occupancy(sp.stride, sp.cin, pl.smem_bytes)
            check(occ >= pl.blocks_per_sm,
                  f"{name} B{batch}: {occ} blocks fit per SM, the plan "
                  f"assumes {pl.blocks_per_sm}")
            tiles.append(f"{name} {pl.tile_rows} rows x {pl.units} units on "
                         f"{pl.grid} blocks ({pl.smem_bytes} B, "
                         f"{pl.blocks_per_sm}/SM, card {occ}/SM)")
        say(f"[build] fused_dsc plan B{batch} == the launcher's: "
            + "; ".join(tiles))
    for d in range(16, 257, 16):
        check(flash_attention.kernel_smem_bytes(d) == flash_attention.plan(
            1, 64, 64, 1, 1, d).smem_bytes,
            f"flash bf16 shared memory at d {d} != flash_attention.plan")
    # the FFN launcher's plan (shared memory, grid, workspace, ...) is
    # fused_ffn.plan, at the serve path's shapes and the checks' shapes
    cfg = registry.get("gemma2-9b")
    shapes = [(t, cfg.d_model, cfg.d_ff) for t in (1, 4, 77, 1000, 2048)]
    shapes += [(t, d, f) for t, d, f, *_ in FFN_CASES]
    for dtype in (torch.bfloat16, torch.float32):
        for t, d, f in shapes:
            pl = fused_ffn.plan(t, d, f, dtype, n_sm)
            check(fused_ffn.kernel_plan(t, d, f, dtype, n_sm) == pl.as_tuple(),
                  f"ffn launcher plan != fused_ffn.plan at T {t}, d {d}, "
                  f"d_ff {f}, {dtype}")
    for t in (2048, 4):
        pl = fused_ffn.plan(t, cfg.d_model, cfg.d_ff, torch.bfloat16, n_sm)
        resident = fused_ffn.max_active_clusters(t, cfg.d_model, cfg.d_ff, n_sm)
        say(f"[build] fused_ffn plan gemma2-9b T {t}: cluster {pl.cluster}, "
            f"{pl.cols} columns per block, chunk {pl.chunk}, {pl.stages} ring "
            f"stages, {pl.groups} d_ff groups, grid {pl.grid}, shared memory "
            f"{pl.smem_bytes} B, workspace {pl.ws_bytes} B; == the launcher's; "
            f"{resident} clusters resident at once, so "
            f"{-(-pl.grid[1] * pl.grid[2] // resident)} waves")


def sass_counts(lib_path: Path, opcode: str):
    """{kernel: instructions whose opcode starts with ``opcode``} in a
    library's SASS (``cuobjdump -sass``), or None without cuobjdump."""
    tool = shutil.which("cuobjdump", path=os.pathsep.join(
        [os.environ.get("PATH", ""), build.CUDA_BIN]))
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            args = re.findall(r"Li(-?\d+)E", mangled)
            kernel = (re.sub(r"^_ZN.*?\d+(?=[a-z_]+_kernel)", "", mangled)
                      .split("I")[0] + (f"<{', '.join(args)}>" if args else ""))
            counts[kernel] = 0
        elif kernel is not None and re.search(rf"\b{opcode}", line):
            counts[kernel] += 1
    return counts


def ptxas_kernels(lines):
    """(kernel, registers, spill line) for each entry function that ptxas
    compiled, from its "-v" lines."""
    out, name, spills = [], None, "no spill line"
    for line in lines:
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = next((k for k in ("flash_wgmma_kernel", "flash_f32_kernel",
                                     "ffn_wgmma_kernel", "ffn_f32_kernel",
                                     "reduce_kernel", "fused_dsc_kernel")
                         if k in mangled), mangled)
            tmpl = mangled.split(name, 1)[-1]
            if tmpl[:3] == "ILi":     # int template arguments
                name += f"<{', '.join(re.findall(r'Li(-?\d+)E', tmpl))}>"
            elif tmpl[:2] == "I1":    # a type: reduce_kernel<bf16 / float>
                name += "<bf16>" if "bfloat16" in tmpl else ""
            elif tmpl[:3] == "IfE":
                name += "<float>"
            spills = "no spill line"
        elif "spill" in line:
            spills = line
        elif "Used" in line and "registers" in line and name is not None:
            out.append((name, int(line.split("Used")[1].split()[0]), spills))
            name = None
    return out


def run_kernel_vs_plain(name, x_cpu, qp_cpu, device, tile_rows) -> None:
    """Kernel on the card vs the plain version on the card and on the CPU."""
    tensors, st = block_args(qp_cpu)
    x = x_cpu.to(device)
    dev_tensors = [t.to(device) for t in tensors]
    got = fused_dsc.fused_dsc_cuda(x, *dev_tensors, tile_rows=tile_rows, **st)
    plain = ref.fused_dsc_ref(x, *dev_tensors, **st)
    torch.cuda.synchronize()
    plain_cpu = ref.fused_dsc_ref(x_cpu, *tensors, **st)
    err = int((got.cpu().to(torch.int32) - plain_cpu.to(torch.int32))
              .abs().max())
    check(got.shape == plain_cpu.shape, f"{name}: shape {tuple(got.shape)}")
    check(torch.equal(got, plain), f"{name}: kernel != plain version on card")
    check(torch.equal(got.cpu(), plain_cpu),
          f"{name}: kernel != plain version on CPU (max |diff| {err})")


def phase_kernel_vs_plain(net_cpu, device):
    rng = np.random.default_rng(11)
    n = 0
    for batch, tiles in ((64, (4, None)), (1, (None,)), (256, (None,))):
        for name, x, qp in network_block_cases(net_cpu, batch, rng):
            for tile_rows in tiles:
                run_kernel_vs_plain(f"{name} B{batch}", x, qp, device,
                                    tile_rows)
                n += 1
    for name, x, qp, tile_rows in ragged_block_cases(rng):
        run_kernel_vs_plain(name, x, qp, device, tile_rows)
        n += 1
    say(f"[kernel] fused_dsc == fused_dsc_ref (card and CPU) on {n} cases: "
        f"the seven blocks at batch 64 (4-row and planned tiles), 1 and 256 "
        f"(planned tiles), nine ragged shapes")


def phase_end_to_end(net_cpu, device, batch=256) -> int:
    """Returns the kernel launches of one forward through the main path."""
    net = net_cpu.to(device)
    imgs = np.random.default_rng(1).standard_normal(
        (batch, 80, 80, 3)).astype(np.float32)
    imgs_dev = torch.from_numpy(imgs).to(device)
    fused_dsc.LAUNCHES = 0
    logits_q = mnv2.forward_batch(imgs_dev, net, use_kernel=True,
                                  return_quantized=True)
    torch.cuda.synchronize()
    launches = fused_dsc.LAUNCHES
    check(launches == len(net.blocks),
          f"forward launched the kernel {launches} times, expected "
          f"{len(net.blocks)}")
    want_stages = mnv2.forward_stages(imgs, net_cpu,
                                      Schedule.V0_LAYER_BY_LAYER)
    want = want_stages[-1]
    check(logits_q.shape == (batch, 2) and logits_q.dtype == torch.int8,
          f"logits {tuple(logits_q.shape)} {logits_q.dtype}")
    check(torch.equal(logits_q.cpu(), want),
          "int8 logits (kernel, card) != plain v0 forward (CPU)")
    names = ["stem"] + [n for n, *_ in mnv2.PAPER_BLOCKS] + ["logits"]
    got_stages = mnv2.forward_stages(imgs_dev, net, use_kernel=True)
    for name, got, ref_stage in zip(names, got_stages, want_stages):
        check(torch.equal(got.cpu(), ref_stage),
              f"stage {name}: kernel path (card) != plain v0 (CPU)")
    plain_dev = mnv2.forward_batch(imgs_dev, net, return_quantized=True,
                                   schedule=Schedule.V0_LAYER_BY_LAYER)
    check(torch.equal(plain_dev.cpu(), want),
          "int8 logits (plain v0, card) != plain v0 forward (CPU)")
    logits = mnv2.forward_batch(imgs_dev, net, use_kernel=True)
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    counts = np.bincount(want.numpy().argmax(-1), minlength=2).tolist()
    say(f"[e2e] {batch} images 80x80: int8 stem, blocks and logits (kernel, "
        f"card) == plain v0 (CPU); {launches} launches per forward; class counts {counts}; "
        f"logit range [{int(want.min())}, {int(want.max())}]")
    return launches


def phase_serve(net_cpu, batch=256):
    fused_dsc.LAUNCHES = 0
    preds = serve.main(["--mobilenet", "--batch", str(batch)])
    sizes = len({1 << i for i in range(batch.bit_length())
                 if 1 << i <= batch} | {batch})
    want_launches = 2 * sizes * len(net_cpu.blocks)
    check(fused_dsc.LAUNCHES == want_launches,
          f"serve launched {fused_dsc.LAUNCHES}, expected {want_launches}")
    imgs = np.random.default_rng(0).standard_normal(
        (batch, 80, 80, 3)).astype(np.float32)
    want = mnv2.forward_batch(imgs, net_cpu,
                              schedule=Schedule.V0_LAYER_BY_LAYER).argmax(-1)
    check(np.array_equal(preds, want.numpy()),
          "served predictions != plain v0 forward (CPU)")
    say(f"[serve] {batch} requests answered; {fused_dsc.LAUNCHES} launches; "
        "predictions == plain v0 forward (CPU)")


def time_ms(fn, iters: int = 50, reps: int = 4) -> float:
    """Device time of one ``fn()`` call: ``iters`` calls captured into one
    CUDA graph, replayed ``reps`` times between two CUDA events, so the
    host's per-call overhead does not enter the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up: allocator, shared-memory opt-in
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def bound(x, qp):
    """(ops, bytes, bound_ms, bound_by): the block's work and the least time
    for it on an H100 SXM. Ops: 2 per int8 MAC of the layer-by-layer
    formulas. Bytes: every input read once (activation, weights, biases,
    multipliers), the output written once."""
    spec = qp.spec
    b, h, w, _ = x.shape
    h2, w2 = spec.out_hw(h, w)
    ops = 2 * b * sum(spec.macs(h, w).values())
    tensors, _ = block_args(qp)
    nbytes = (x.numel() + b * h2 * w2 * spec.cout
              + sum(t.numel() * t.element_size() for t in tensors))
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES
    return (ops, nbytes, max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def phase_kernel_times(net_cpu, device, launches_per_forward, batch=256):
    rng = np.random.default_rng(12)
    entries = []
    per_block = launches_per_forward // len(net_cpu.blocks)
    for name, x_cpu, qp in network_block_cases(net_cpu, batch, rng):
        tensors, st = block_args(qp)
        x = x_cpu.to(device)
        ts = [t.to(device) for t in tensors]
        kern = lambda: fused_dsc.fused_dsc_cuda(x, *ts, **st)
        plain = lambda: ref.fused_dsc_ref(x, *ts, **st)
        err = int((kern().to(torch.int32) - plain().to(torch.int32))
                  .abs().max())
        check(err == 0, f"{name} @ batch {batch}: kernel != plain ({err})")
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        ops, nbytes, bound_ms, bound_by = bound(x, qp)
        entries.append({
            "name": f"fused_dsc[{name} B{batch}]", "route": "cuda",
            "source": SOURCE, "batch": batch,
            "replaces": REPLACES, "launches": per_block, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "ops": ops, "bytes": nbytes,
            "shape": list(x.shape), "cmid": qp.spec.cmid,
            "cout": qp.spec.cout, "stride": qp.spec.stride})
        say(f"[time] {name:>4} B{batch} x{tuple(x.shape)}: kernel {ms:.6f} ms, plain "
            f"{plain_ms:.6f} ms, bound {bound_ms:.6f} ms ({bound_by}), "
            f"{bound_ms / ms:.2%} of bound")
    total = sum(e["ms"] for e in entries)
    say(f"[time] seven blocks at batch {batch}: kernel {total:.6f} ms, "
        f"bound {sum(e['bound_ms'] for e in entries):.6f} ms")
    return entries


def host_and_device_ms(fn, reps=5):
    """(host-clock ms per ``fn()`` call, unprofiled; device-busy ms per call
    from torch.profiler (CUPTI) or None where it records no device time;
    device activities per call; {name: device ms per call})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in on_device:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.device_time_total / 1e3 / reps)
    busy_ms = sum(by_name.values()) if on_device else None
    return host_ms, busy_ms, len(on_device) // reps, by_name


def busy_line(host_ms, busy_ms, n_act) -> str:
    if busy_ms is None:
        return (f"{host_ms:.6f} ms (host clock); the profiler recorded no "
                "device time: busy share not measured")
    return (f"{host_ms:.6f} ms (host clock); device busy {busy_ms:.6f} ms "
            f"({busy_ms / host_ms:.2%}), idle share "
            f"{1 - busy_ms / host_ms:.2%}; {n_act} device activities")


def phase_profile(net_cpu, device, batches=(1, 256), reps=5):
    """Where a forward's time goes: the host-clock latency of the eager
    forward (unprofiled), and the device time its kernels and copies take
    (torch.profiler, CUPTI). Their difference is the device's idle time."""
    net = net_cpu.to(device)
    rng = np.random.default_rng(2)
    for batch in batches:
        imgs = torch.from_numpy(rng.standard_normal(
            (batch, 80, 80, 3)).astype(np.float32)).to(device)
        host_ms, busy_ms, n_act, by_name = host_and_device_ms(
            lambda: mnv2.forward_batch(imgs, net, use_kernel=True), reps)
        say(f"[profile] batch {batch}: eager forward "
            f"{busy_line(host_ms, busy_ms, n_act)} per forward")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            say(f"[profile]   {ms:.6f} ms  {name[:90]}")


# ---------------------------------------------------------------------------
# CFU path: the compiled VWW network through the fast path
# ---------------------------------------------------------------------------

CFU_SCHEDULES = schedule_names(include_auto=True)
CFU_STREAMS = (1, 3)
# DSC kernel launches per fast-path call of the VWW network: fused and
# row-tile stages run the kernel; winograd runs its own stage body on the
# four stride-1 blocks and fused on the three stride-2 ones; layer
# schedules run the plain layer-by-layer block.
CFU_LAUNCHES = {"fused": 7, "fused-rowtile": 7, "fused-winograd": 3,
                "layer-dram": 0, "layer-sram": 0}
# tests/test_cfu_fastpath.py's chain: widths the kernel does not take
NARROW_CHAIN = (S(3, 9, 5, 1), S(5, 15, 5, 2), S(5, 10, 4, 1))


def cfu_launches(sched: str, prog) -> int:
    """The DSC kernel launches one fast-path call of ``prog`` must make:
    one per block the compiler lowered to fused or row-tile."""
    picks = prog.meta["block_schedules"].values()
    n = sum(1 for p in picks if p in ("fused", "fused-rowtile"))
    check(CFU_LAUNCHES.get(sched, n) == n,
          f"{sched}: {n} fused/row-tile blocks, expected {CFU_LAUNCHES}")
    return n


def phase_cfu_compile():
    """The 80x80 VWW network through the port's compiler under every
    schedule and ``auto``, on one core and on three; the text assembly
    must re-assemble to the same words."""
    progs = {}
    for sched in CFU_SCHEDULES:
        for streams in CFU_STREAMS:
            t0 = time.perf_counter()
            prog = compile_vww_network(mnv2.block_specs(), 80, sched,
                                       streams=streams)
            secs = time.perf_counter() - t0
            words = []
            for p in getattr(prog, "streams", None) or [prog]:
                enc = isa.encode_program(p)
                back = isa.encode_program(
                    isa.program_from_asm(isa.program_to_asm(p)))
                check(np.array_equal(back, enc),
                      f"{sched} streams {streams}: assembly round trip "
                      "changed the words")
                words.append(len(enc))
            progs[(sched, streams)] = prog
            say(f"[cfu] {sched} streams {streams}: words per stream {words}, "
                f"fingerprint {fastpath.program_fingerprint(prog)}, compiled "
                f"in {secs:.3f} s; assembly round trip equal")
    return progs


def phase_cfu_vs_golden(net_cpu, progs, device, batch=4):
    """``run_fast`` on the card against the port's golden executor on the
    same images, for every (schedule, streams), with the DSC launches each
    call must make; and the narrow chain refused on the card."""
    params = vww_cfu_params(net_cpu)
    imgs = np.random.default_rng(3).standard_normal(
        (batch, 80, 80, 3)).astype(np.float32)
    x_q = quant.quantize(imgs, net_cpu.qp_img).numpy()
    for (sched, streams), prog in progs.items():
        t0 = time.perf_counter()
        golden = (run_program(prog, x_q, params) if streams == 1
                  else run_multistream(prog, x_q, params, batch=batch))
        golden_s = time.perf_counter() - t0
        fused_dsc.LAUNCHES = 0
        got = fastpath.run_fast(prog, x_q, params, device=device)
        torch.cuda.synchronize()
        n = fused_dsc.LAUNCHES
        want_n = cfu_launches(sched, prog)
        check(n == want_n, f"{sched} streams {streams}: {n} DSC launches, "
              f"expected {want_n}")
        check(got.device.type == torch.device(device).type
              and got.dtype == torch.int8,
              f"{sched}: fast path returned {got.dtype} on {got.device}")
        check(np.array_equal(got.cpu().numpy(), golden),
              f"{sched} streams {streams}: fast path (card) != golden "
              "executor")
        say(f"[cfu] {sched} streams {streams} B{batch}: fast path (card) == "
            f"golden executor ({golden_s:.2f} s); {n} DSC launches")
    specs = [(f"b{i}", spec) for i, spec in enumerate(NARROW_CHAIN)]
    chain = random_chain_params(0, specs, 13)
    prog = compile_network(specs, 13, 13, "fused")
    x = np.zeros((13, 13, 3), np.int8)
    try:
        fastpath.run_fast(prog, x, chain, device=device)
    except fastpath.FastPathError as e:
        say(f"[cfu] narrow chain (C 3, M 9) on the card refused: {e}")
    else:
        check(False, "the narrow chain ran on the card: the width refusal "
              "did not fire")


def phase_cfu_batch(net_cpu, progs, device, batch=256):
    """At batch 256, one core: the fast path's int8 logits on the card must
    equal ``forward_batch(use_kernel=True)`` and the CPU fast path (the
    plain versions). Returns {schedule: DSC launches per call}."""
    params = vww_cfu_params(net_cpu)
    net = net_cpu.to(device)
    imgs = np.random.default_rng(4).standard_normal(
        (batch, 80, 80, 3)).astype(np.float32)
    x_q = quant.quantize(imgs, net_cpu.qp_img).numpy()
    want = mnv2.forward_batch(torch.from_numpy(imgs).to(device), net,
                              use_kernel=True, return_quantized=True)
    launches = {}
    for sched in CFU_SCHEDULES:
        prog = progs[(sched, 1)]
        fused_dsc.LAUNCHES = 0
        got = fastpath.run_fast(prog, x_q, params, device=device)
        torch.cuda.synchronize()
        launches[sched] = fused_dsc.LAUNCHES
        check(launches[sched] == cfu_launches(sched, prog),
              f"{sched} B{batch}: {launches[sched]} DSC launches")
        check(torch.equal(got, want),
              f"{sched} B{batch}: fast path != forward_batch (card)")
        cpu = fastpath.run_fast(prog, x_q, params, device="cpu")
        check(torch.equal(got.cpu(), cpu),
              f"{sched} B{batch}: fast path (card) != fast path (CPU)")
        say(f"[cfu] {sched} B{batch}: int8 logits (card) == forward_batch "
            f"(kernel, card) == fast path (CPU); {launches[sched]} DSC "
            "launches")
    return launches


def phase_cfu_entry_point(batch=256):
    argv = ["--network", "vww", "--backend", "fast", "--batch", str(batch),
            "--schedule", "all"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cfu_cli.main(argv)
    lines = out.getvalue().splitlines()
    for line in lines:
        say(f"[cfu-cli] {line}")
    rows = [ln.split(",") for ln in lines
            if ln and not ln.startswith(("#", "schedule,"))]
    check(len(rows) == len(schedule_names()),
          f"launch.cfu printed {len(rows)} schedule rows")
    for row in rows:
        check(row[-3:-1] == ["True", "True"],
              f"launch.cfu {row[0]}: verified {row[-3:-1]}")
    say(f"[cfu-cli] launch.cfu {' '.join(argv)}: every schedule verified")


def phase_cfu_times(net_cpu, progs, device, batches=(1, 256)):
    """What the fast path costs on the card, beside ``forward_batch`` on the
    same weights: host-clock ms per call (``run_fast``, and the executor it
    looks up, called directly), device-busy ms, idle share; and
    the seven DSC launches at the row-tile stream's tile rows against the
    plan's pick (CUDA-graph time)."""
    params = vww_cfu_params(net_cpu)
    net = net_cpu.to(device)
    card = card_line()
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    rowtile = fastpath.fast_executor(progs[("fused-rowtile", 1)], params,
                                     device=device)
    rng = np.random.default_rng(6)
    for batch in batches:
        imgs = rng.standard_normal((batch, 80, 80, 3)).astype(np.float32)
        imgs_dev = torch.from_numpy(imgs).to(device)
        x_dev = quant.quantize(imgs_dev, net.qp_img)
        calls = []
        for s in ("fused", "fused-rowtile"):
            ex = fastpath.fast_executor(progs[(s, 1)], params, device=device)
            # run_fast looks the executor up by fingerprint on every call
            calls.append((f"run_fast {s}", lambda s=s: fastpath.run_fast(
                progs[(s, 1)], x_dev, params, device=device)))
            calls.append((f"executor call {s} (after the lookup)",
                          lambda ex=ex: ex(x_dev, params)))
        calls.append(("forward_batch", lambda: mnv2.forward_batch(
            imgs_dev, net, use_kernel=True, return_quantized=True)))
        for label, fn in calls:
            host_ms, busy_ms, n_act, _ = host_and_device_ms(fn)
            say(f"[cfu-time] {card} B{batch} {label}: "
                f"{busy_line(host_ms, busy_ms, n_act)} per call")
        stages = [st for st in rowtile.stages if st.kind == "dsc"]
        tot_stream = tot_plan = 0.0
        for st, qp in zip(stages, net_cpu.blocks):
            tensors, stat = block_args(qp)
            ts = [t.to(device) for t in tensors]
            x = torch.from_numpy(rng.integers(
                -128, 128, (batch, st.h, st.w, st.cin), np.int8)).to(device)
            pick = fused_dsc.plan(batch, st.h, st.w, st.cin, st.cmid,
                                  st.cout, st.stride, None, n_sm).tile_rows
            ms_stream = time_ms(lambda: fused_dsc.fused_dsc_cuda(
                x, *ts, tile_rows=st.tile_rows, **stat))
            ms_plan = time_ms(lambda: fused_dsc.fused_dsc_cuda(
                x, *ts, tile_rows=None, **stat))
            tot_stream += ms_stream
            tot_plan += ms_plan
            say(f"[cfu-time] {card} B{batch} block {st.block} "
                f"{st.h}x{st.w}x{st.cin} s{st.stride}: stream tile_rows "
                f"{st.tile_rows} {ms_stream:.6f} ms, plan's {pick} "
                f"{ms_plan:.6f} ms")
        say(f"[cfu-time] {card} B{batch} seven DSC launches: stream tiles "
            f"{tot_stream:.6f} ms, plan's tiles {tot_plan:.6f} ms")


# ---------------------------------------------------------------------------
# LM path: gemma2-9b serving through the flash-attention and fused-FFN kernels
# ---------------------------------------------------------------------------

PEAK_BF16_FLOPS = 989e12
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:42"
FFN_SOURCE = "src/repro_torch/kernels/csrc/fused_ffn.cu"
FFN_REPLACES = "src/repro/kernels/fused_ffn.py:44"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 512, 16
F32_TOL, BF16_TOL = 2e-5, 2e-2   # tests/test_kernels.py's tolerances
# bf16 outputs are also held as a whole: ||got - want|| / ||want|| below
# 1e-2 (two bf16 roundings of one value differ by ~4e-3 at most), so a
# structured fault that hides under the elementwise 2e-2 cannot pass.
BF16_NORM_TOL = 1e-2
NO_FFN_LIBRARY = "no single PyTorch call computes the gated FFN"
# (b, tq, tk, h, hkv, d, causal, window, softcap): tests/test_torch_kernels.py
# test_flash_attention_cuda_matches_plain's cases for the wgmma kernel's edges
FLASH_EDGE_CASES = [
    (1, 64, 64, 2, 1, 16, True, None, None),
    (2, 130, 130, 4, 2, 128, True, None, 50.0),
    (2, 40, 40, 2, 2, 64, True, None, None),
    (1, 48, 20, 2, 1, 64, False, None, None),
    (2, 65, 129, 2, 1, 64, False, 48, None),
    (2, 509, 509, 16, 8, 256, True, None, 50.0),
]
# (t, d, f, act, gated): the tests/test_kernels.py FFN sweep, an ungated
# and a relu case
FFN_CASES = [(t, d, f, act, True) for t, d, f in
             ((64, 128, 512), (32, 64, 192), (128, 128, 384))
             for act in ("silu", "gelu", "relu_sq")]
FFN_CASES += [(64, 96, 256, "gelu", False), (48, 128, 256, "relu", True)]
# A flash measurement shape beside the path: the longest prompt that a
# local layer's window covers, where the products bound the kernel.
LONG_BATCH, LONG_PROMPT = 1, 4096


def gemma(**over):
    return dataclasses.replace(registry.get("gemma2-9b"), **over)


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def rel_norm(got, want) -> float:
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


def close(got, want, tol, what: str) -> tuple[float, float]:
    """Holds ``got`` to ``want`` elementwise (atol = rtol = ``tol``) and, in
    bf16, by relative norm; returns (max |diff|, relative norm)."""
    err, rel = max_err(got, want), rel_norm(got, want)
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
    if got.dtype == torch.bfloat16:
        ok = ok and rel < BF16_NORM_TOL
    check(bool(ok) and got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: kernel vs plain version, max |diff| {err} (tol {tol}), "
          f"relative norm {rel}")
    return err, rel


def rand(gen, shape, dtype, scale=1.0, device="cuda"):
    return (torch.randn(shape, generator=gen, device=device)
            * scale).to(dtype)


def cpu_attention_ref(q, k, v, **kw):
    """The plain attention on the CPU. In float32 it is computed in float64
    and cast to float32: the card's kernel is deterministic and the host's
    float32 order of sums is no better a reference than the kernel's
    (probes/flash_f32_repeat.py)."""
    q, k, v = q.cpu(), k.cpu(), v.cpu()
    if q.dtype == torch.float32:
        return ref.attention_ref(q.double(), k.double(), v.double(),
                                 **kw).float()
    return ref.attention_ref(q, k, v, **kw)


def phase_lm_kernel_vs_plain(device):
    """Both LM kernels against their plain versions: the tests/test_kernels.py
    matrices (on the card and on the CPU) and gemma2-9b's shapes (card)."""
    gen = torch.Generator(device=device).manual_seed(21)
    n, worst = 0, 0.0   # worst: the largest bf16 relative norm
    flash_cases = [(128, 128, 64, True, None, None),
                   (256, 256, 64, True, None, 50.0),
                   (128, 384, 64, False, None, None),
                   (256, 256, 64, True, 64, None),
                   (100, 100, 32, True, None, None),
                   (64, 160, 32, False, 48, None)]
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for tq, tk, d, causal, window, softcap in flash_cases:
            q, k, v = (rand(gen, (4, t, d), dtype, device=device)
                       for t in (tq, tk, tk))
            kw = dict(causal=causal, window=window, softcap=softcap)
            got = ops.attention(q, k, v, **kw)
            name = f"flash {tq}x{tk}x{d} {kw} {dtype}"
            _, rel = close(got, ref.attention_ref(q, k, v, **kw), tol,
                           name + " card")
            close(got.cpu(), cpu_attention_ref(q, k, v, **kw), tol,
                  name + " CPU")
            worst = max(worst, rel) if dtype == torch.bfloat16 else worst
            n += 1
    # gemma2-9b: B 4, 16 query / 8 KV heads, d 256, causal, softcap 50;
    # window 4096 (local), none (global), 64 (the window binding); ragged P
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for p_len, window in ((512, 4096), (512, None), (512, 64), (509, 4096),
                              (509, 64)):
            q = rand(gen, (LM_BATCH, p_len, 16, 256), dtype, device=device)
            k, v = (rand(gen, (LM_BATCH, p_len, 8, 256), dtype, device=device)
                    for _ in range(2))
            kw = dict(causal=True, window=window, softcap=50.0)
            got = ops.mha(q, k, v, n_kv_heads=8, **kw)
            _, rel = close(got, ref.mha_ref(q, k, v, **kw), tol,
                           f"flash gemma P{p_len} window {window} {dtype}")
            worst = max(worst, rel) if dtype == torch.bfloat16 else worst
            n += 1
    # the wgmma kernel's edges: d 16 and 128 (d padded to TMA boxes), Tk < 64,
    # ragged boxes on both edges (Tq 65, Tk 129, window 48), P 509 unwindowed
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for b, tq, tk, h, hkv, d, causal, window, softcap in FLASH_EDGE_CASES:
            q = rand(gen, (b, tq, h, d), dtype, device=device)
            k, v = (rand(gen, (b, tk, hkv, d), dtype, device=device)
                    for _ in range(2))
            kw = dict(causal=causal, window=window, softcap=softcap)
            got = ops.mha(q, k, v, n_kv_heads=hkv, **kw)
            _, rel = close(got, ref.mha_ref(q, k, v, **kw), tol,
                           f"flash edge B{b} {tq}x{tk} H{h}/{hkv} d{d} {kw} "
                           f"{dtype}")
            worst = max(worst, rel) if dtype == torch.bfloat16 else worst
            n += 1
    say(f"[lm-kernel] flash_attention == attention_ref on {n} shapes "
        f"(f32 2e-5, bf16 2e-2 and relative norm < {BF16_NORM_TOL}: largest "
        f"bf16 relative norm {worst:.6e})")

    n, worst = 0, 0.0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for t, d, f, act, gated in FFN_CASES:
            x = rand(gen, (t, d), dtype, device=device)
            wg, wu, wd = (rand(gen, s, dtype, 0.05, device)
                          for s in ((d, f), (d, f), (f, d)))
            wg = wg if gated else None
            got = ops.ffn(x, wg, wu, wd, act=act)
            name = f"ffn {t}x{d}x{f} {act} gated={gated} {dtype}"
            _, rel = close(got, ref.fused_ffn_ref(x, wg, wu, wd, act=act), tol,
                           name + " card")
            close(got.cpu(), ref.fused_ffn_ref(
                x.cpu(), None if wg is None else wg.cpu(), wu.cpu(), wd.cpu(),
                act=act), tol, name + " CPU")
            worst = max(worst, rel) if dtype == torch.bfloat16 else worst
            n += 1
    cfg = registry.get("gemma2-9b")
    d, f = cfg.d_model, cfg.d_ff
    for dtype, tol, ts in ((torch.bfloat16, BF16_TOL, (1, 4, 2048, 1000)),
                           (torch.float32, F32_TOL, (1, 77))):
        wg, wu = (rand(gen, (d, f), dtype, d ** -0.5, device) for _ in range(2))
        wd = rand(gen, (f, d), dtype, f ** -0.5, device)
        for t in ts:
            x = rand(gen, (t, d), dtype, device=device)
            got = ops.ffn(x, wg, wu, wd, act="gelu")
            _, rel = close(got, ref.fused_ffn_ref(x, wg, wu, wd, act="gelu"),
                           tol, f"ffn gemma T{t} {dtype}")
            worst = max(worst, rel) if dtype == torch.bfloat16 else worst
            n += 1
        del wg, wu, wd
    say(f"[lm-kernel] fused_ffn == fused_ffn_ref on {n} shapes "
        f"(f32 2e-5, bf16 2e-2 and relative norm < {BF16_NORM_TOL}: largest "
        f"bf16 relative norm {worst:.6e})")


class Checked:
    """Within the block, every ``ops.mha`` / ``ops.ffn`` call made by the
    model also runs the plain version on the same inputs and holds the
    kernel's output to it. The plain calls launch no kernel."""

    def __init__(self, tol: float):
        self.tol, self.saved = tol, None
        self.errs = {"flash": 0.0, "ffn": 0.0}   # largest max |diff|
        self.rels = {"flash": 0.0, "ffn": 0.0}   # largest relative norm

    def _note(self, kernel, err_rel):
        self.errs[kernel] = max(self.errs[kernel], err_rel[0])
        self.rels[kernel] = max(self.rels[kernel], err_rel[1])

    def __enter__(self):
        self.saved = (ops.mha, ops.ffn)
        mha, ffn = self.saved

        def mha_checked(q, k, v, *, n_kv_heads, **kw):
            out = mha(q, k, v, n_kv_heads=n_kv_heads, **kw)
            self._note("flash", close(out, ref.mha_ref(q, k, v, **kw),
                                      self.tol,
                                      f"model flash call {tuple(q.shape)}"))
            return out

        def ffn_checked(x, w_gate, w_up, w_down, *, act):
            out = ffn(x, w_gate, w_up, w_down, act=act)
            self._note("ffn", close(
                out, ref.fused_ffn_ref(x, w_gate, w_up, w_down, act=act),
                self.tol, f"model ffn call {tuple(x.shape)}"))
            return out

        ops.mha, ops.ffn = mha_checked, ffn_checked
        return self

    def __exit__(self, *exc):
        ops.mha, ops.ffn = self.saved


def reset_lm_counts():
    flash_attention.LAUNCHES = 0
    fused_ffn.LAUNCHES = 0


def lm_counts():
    return flash_attention.LAUNCHES, fused_ffn.LAUNCHES


def greedy(logits, cfg):
    return logits[:, :cfg.vocab].argmax(dim=-1)


class PlainOps:
    """Within the block, ``ops.mha`` / ``ops.ffn`` run the kernels' plain
    versions: the same function, with bf16 rounding at other places."""

    def __enter__(self):
        self.saved = (ops.mha, ops.ffn)
        ops.mha = lambda q, k, v, *, n_kv_heads, **kw: ref.mha_ref(q, k, v,
                                                                   **kw)
        ops.ffn = ref.fused_ffn_ref
        return self

    def __exit__(self, *exc):
        ops.mha, ops.ffn = self.saved


def hidden_states(params, cfg, tokens):
    """The residual stream after the embedding and after every layer of a
    prefill, and the last-token logits."""
    x = lm._embed(params, cfg, tokens)
    cache = lm.init_cache(cfg, tokens.shape[0], tokens.shape[1],
                          device=tokens.device)
    states = [x]
    for p, kind, key in lm._layers(params, cfg):
        x, _ = lm.layer_prefill(x, p, kind, cfg, lm._layer_cache(cache, key))
        states.append(x)
    return states, lm._head(params, cfg, x[:, -1:])[:, 0]


def lm_divergence(params, cfg, prompts):
    """Prints (information, not a gate) the relative distance of the
    residual stream, layer by layer, between three bf16 paths: the kernel
    path, the same disciplines with the kernels' plain versions, and the
    plain disciplines (attention fused, FFN reference); and their last-token
    logit gaps and greedy agreement. The last pair has no kernel on either
    side: if it drifts as far as the pairs with the kernel path, the drift
    is bf16 rounding carried by depth, not a kernel bias."""
    hk, lk = hidden_states(params, cfg, prompts)
    with PlainOps():
        hp, lp = hidden_states(params, cfg, prompts)
    hd, ld = hidden_states(
        params, gemma(attn_impl="fused", block_impl="reference"), prompts)
    layers = [i for i in (1, 2, 6, 12, 21, 30, 42) if i < len(hk)]
    for name, ha, la, hb, lb in (
            ("kernel path vs plain versions of the kernels", hk, lk, hp, lp),
            ("kernel path vs plain disciplines", hk, lk, hd, ld),
            ("plain versions vs plain disciplines (no kernel)", hp, lp, hd,
             ld)):
        gaps = ", ".join(f"{i}: {rel_norm(ha[i], hb[i]):.6f}" for i in layers)
        agree = int((greedy(la, cfg) == greedy(lb, cfg)).sum())
        say(f"[lm-e2e] bf16 {name}: residual relative distance after layer "
            f"{{{gaps}}}; last-token logit max |diff| {max_err(la, lb)} "
            f"(logit std {float(la.std()):.6f}); greedy tokens agree "
            f"{agree}/{la.shape[0]} (information, not a gate)")


def phase_lm_end_to_end(device):
    """Full-width, full-depth gemma2-9b in bf16: one prefill and one decode
    step through the kernels, every kernel call held to its plain version;
    the same weights under the plain disciplines for information; then one
    pattern unit in float32, kernel vs reference disciplines."""
    cfg = gemma(attn_impl="kernel", block_impl="fused")
    n_layers = cfg.n_layers
    t0 = time.perf_counter()
    params = lm.init_params(cfg, 0, device)
    torch.cuda.synchronize()
    say(f"[lm-e2e] gemma2-9b: {cfg.param_count():,} params, bf16, "
        f"{n_layers} layers, seeded on the card in "
        f"{time.perf_counter() - t0:.3f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(device)
    max_len = LM_PROMPT + LM_GEN
    with Checked(BF16_TOL) as chk:
        reset_lm_counts()
        logits, cache = lm.prefill(params, cfg, prompts, max_len=max_len)
        torch.cuda.synchronize()
        pre = lm_counts()
        tok = greedy(logits, cfg)
        reset_lm_counts()
        logits2, cache = lm.decode_step(params, cfg, cache, tok, LM_PROMPT)
        torch.cuda.synchronize()
        dec = lm_counts()
    check(pre == (n_layers, n_layers),
          f"prefill launched (flash, ffn) {pre}, expected {n_layers} each")
    check(dec == (0, n_layers),
          f"decode step launched (flash, ffn) {dec}, expected (0, {n_layers})")
    for name, lg in (("prefill", logits), ("decode", logits2)):
        check(lg.shape == (LM_BATCH, cfg.vocab_padded())
              and bool(torch.isfinite(lg).all()),
              f"{name} logits {tuple(lg.shape)} not finite or wrong shape")
    say(f"[lm-e2e] prefill B{LM_BATCH} P{LM_PROMPT}: launches (flash, ffn) "
        f"{pre}; decode step: {dec}; every call within {BF16_TOL} of its "
        f"plain version and within relative norm {BF16_NORM_TOL} (max |diff| "
        f"flash {chk.errs['flash']}, ffn {chk.errs['ffn']}; largest relative "
        f"norm flash {chk.rels['flash']:.6e}, ffn {chk.rels['ffn']:.6e})")
    # information: how far bf16 rounding carries through 42 layers
    lm_divergence(params, cfg, prompts)
    del params, cache, logits, logits2
    torch.cuda.empty_cache()

    # one pattern unit (2 layers) at full width in float32
    tol = 1e-3
    f32 = dict(n_layers=len(cfg.pattern), dtype="float32")
    kcfg = gemma(attn_impl="kernel", block_impl="fused", **f32)
    rcfg = gemma(attn_impl="reference", block_impl="reference", **f32)
    params = lm.init_params(kcfg, 1, device)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 128))).to(device)
    # an f32 KV cache: the default bf16 cache rounds q, k and v in decode,
    # where a 1e-6 difference can flip one rounding
    f32_cache = dict(max_len=130, cache_dtype=torch.float32)
    reset_lm_counts()
    kl, kc = lm.prefill(params, kcfg, prompts, **f32_cache)
    kl2, _ = lm.decode_step(params, kcfg, kc, greedy(kl, cfg), 128)
    counts = lm_counts()
    rl, rc = lm.prefill(params, rcfg, prompts, **f32_cache)
    rl2, _ = lm.decode_step(params, rcfg, rc, greedy(rl, cfg), 128)
    torch.cuda.synchronize()
    check(counts == (2, 4), f"f32 unit launched (flash, ffn) {counts}")
    e1, e2 = max_err(kl, rl), max_err(kl2, rl2)
    check(e1 <= tol and e2 <= tol,
          f"f32 unit: kernel vs reference logits differ by {e1}, {e2}")
    check(torch.equal(greedy(kl, cfg), greedy(rl, cfg)),
          "f32 unit: greedy tokens differ")
    say(f"[lm-e2e] float32, one pattern unit at full width, B2 P128: kernel "
        f"vs reference disciplines last-token logits max |diff| prefill {e1}, "
        f"decode {e2} (tol {tol}); greedy tokens equal")
    del params, kc, rc
    torch.cuda.empty_cache()


def phase_lm_serve(device):
    """The user's entry point: ``launch.serve --arch gemma2-9b``. Its tokens
    must equal a direct prefill/decode_step greedy loop with the same
    seeded weights. Returns the launch counts of the serve run, with the
    FFN's split by token count."""
    ffn_by_t = {}
    real_ffn = ops.ffn

    def tally(x, *a, **kw):
        ffn_by_t[x.shape[0]] = ffn_by_t.get(x.shape[0], 0) + 1
        return real_ffn(x, *a, **kw)

    argv = ["--arch", "gemma2-9b", "--batch", str(LM_BATCH), "--prompt-len",
            str(LM_PROMPT), "--gen", str(LM_GEN)]
    reset_lm_counts()
    ops.ffn = tally
    try:
        gen_tokens = serve.main(argv)
    finally:
        ops.ffn = real_ffn
    torch.cuda.synchronize()
    counts = lm_counts()
    cfg = gemma(attn_impl="kernel", block_impl="fused")
    n = cfg.n_layers
    check(counts == (n, n * LM_GEN),
          f"serve launched (flash, ffn) {counts}, expected ({n}, {n * LM_GEN})")
    check(gen_tokens.shape == (LM_BATCH, LM_GEN), "served token shape")
    params = lm.init_params(cfg, 0, device)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(device)
    logits, cache = lm.prefill(params, cfg, prompts,
                               max_len=LM_PROMPT + LM_GEN)
    tok = greedy(logits, cfg)
    want = [tok]
    for i in range(LM_GEN - 1):
        logits, cache = lm.decode_step(params, cfg, cache, tok, LM_PROMPT + i)
        tok = greedy(logits, cfg)
        want.append(tok)
    want = torch.stack(want, 1).cpu().numpy()
    check(np.array_equal(gen_tokens, want),
          "served tokens != direct prefill/decode_step greedy loop")
    say(f"[lm-serve] {LM_BATCH} prompts x {LM_PROMPT} tokens, {LM_GEN} "
        f"generated each; launches (flash, ffn) {counts}, ffn by token count "
        f"{dict(sorted(ffn_by_t.items()))}; tokens == direct greedy loop")
    return params, cache, {"flash": counts[0], "ffn_prefill": ffn_by_t.get(
        LM_BATCH * LM_PROMPT, 0), "ffn_decode": ffn_by_t.get(LM_BATCH, 0)}


def flash_bound(b, p, h, hkv, d, item=2):
    """Causal attention: QK^T and PV over the lower triangle (halved), q, k,
    v and o each moved once."""
    flops = 4 * b * h * p * p * d / 2
    nbytes = item * (2 * b * p * h * d + 2 * b * p * hkv * d)
    return flops, nbytes


def ffn_bound(t, d, f, item=2):
    """Gated FFN: three matmuls; x, the three weights and y moved once."""
    return 6 * t * d * f, item * (2 * t * d + 3 * d * f)


def lm_row(name, source, replaces, launches, err_rel, ms, plain_ms, flops,
           nbytes, library_ms, library_note, extra):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops > t_bytes else "bytes"
    library = ("none" if library_ms is None else f"{library_ms:.6f} ms")
    say(f"[time] {name}: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by}), {bound_ms / ms:.2%} of bound; "
        f"library {library} ({library_note}); max |diff| {err_rel[0]}, "
        f"relative norm {err_rel[1]:.6e}")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err_rel[0], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_note": library_note,
            "rel_norm_err": err_rel[1], "flops": flops, "bytes": nbytes,
            **extra}


def flex_attention_library(q, k, v, want, *, window, softcap):
    """The library yardstick for the flash kernel: one call of
    ``torch.compile(flex_attention)`` with the logit softcap as its
    ``score_mod``, the causal window as its block mask and GQA, on the same
    inputs in its (B, H, T, d) layout. It is held to the plain version and
    timed here by CUDA graph; the port never calls it. Returns (ms or None,
    note)."""
    build_dir = Path(__file__).resolve().parent / "build"
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(build_dir / sub))
    b, p, h, d = q.shape

    def score_mod(s, b_, h_, q_idx, kv_idx):
        return softcap * torch.tanh(s / softcap)

    def mask_mod(b_, h_, q_idx, kv_idx):
        keep = q_idx >= kv_idx
        return keep if window is None else keep & (q_idx - kv_idx < window)

    try:
        import torch._inductor.config as inductor_config
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        inductor_config.compile_threads = 1   # no compile worker processes
        mask = create_block_mask(mask_mod, None, None, p, p,
                                 device=q.device)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        flex = torch.compile(flex_attention)
        call = lambda: flex(qt, kt, vt, score_mod=score_mod, block_mask=mask,
                            scale=d ** -0.5, enable_gqa=True)
        err, rel = close(call().transpose(1, 2), want, BF16_TOL,
                         "flex_attention at the path shape")
        ms = time_ms(call, 10, 3)
    except Exception as e:   # a yardstick that fails is recorded, not fatal
        torch.cuda.synchronize()
        return None, (f"torch {torch.__version__} flex_attention failed: "
                      f"{type(e).__name__}: {str(e)[:300]}")
    return ms, (f"torch.compile(flex_attention), torch {torch.__version__}, "
                f"softcap score_mod, causal window block mask, GQA; max "
                f"|diff| {err}, relative norm {rel:.6e} to the plain version")


def phase_lm_kernel_times(device, launches):
    """Each LM kernel at its path shapes (bf16): CUDA-graph time, the plain
    version's and the library's time on the same inputs, and the bound."""
    gen = torch.Generator(device=device).manual_seed(31)
    cfg = registry.get("gemma2-9b")
    bf16 = torch.bfloat16
    b, p, h, hkv, hd = LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim_
    q = rand(gen, (b, p, h, hd), bf16, device=device)
    k, v = (rand(gen, (b, p, hkv, hd), bf16, device=device) for _ in range(2))
    kw = dict(causal=True, window=cfg.window, softcap=cfg.attn_softcap)
    kern = lambda: ops.mha(q, k, v, n_kv_heads=hkv, **kw)
    plain = lambda: ref.mha_ref(q, k, v, **kw)
    want = plain()
    err_rel = close(kern(), want, BF16_TOL, "flash at the path shape")
    ms, plain_ms = time_ms(kern, 10, 3), time_ms(plain, 10, 3)
    library_ms, library_note = flex_attention_library(
        q, k, v, want, window=cfg.window, softcap=cfg.attn_softcap)
    rows = [lm_row(
        f"flash_attention[prefill B{b} P{p} H{h}/{hkv} d{hd}]", FLASH_SOURCE,
        FLASH_REPLACES, launches["flash"], err_rel, ms, plain_ms,
        *flash_bound(b, p, h, hkv, hd), library_ms, library_note,
        {"shape": [b, p, h, hkv, hd], "launches_per_prefill": cfg.n_layers,
         "launches_per_decode_step": 0})]
    del q, k, v, want
    # the measurement shape: checked, then timed beside the plain version
    # and the library; the serve path never launches it (0 launches)
    lb, lp = LONG_BATCH, LONG_PROMPT
    q = rand(gen, (lb, lp, h, hd), bf16, device=device)
    k, v = (rand(gen, (lb, lp, hkv, hd), bf16, device=device) for _ in range(2))
    want = plain()
    err_rel = close(kern(), want, BF16_TOL, f"flash at B{lb} P{lp}")
    ms, plain_ms = time_ms(kern, 10, 3), time_ms(plain, 3, 2)
    library_ms, library_note = flex_attention_library(
        q, k, v, want, window=cfg.window, softcap=cfg.attn_softcap)
    rows.append(lm_row(
        f"flash_attention[measurement B{lb} P{lp} H{h}/{hkv} d{hd}]",
        FLASH_SOURCE, FLASH_REPLACES, 0, err_rel, ms, plain_ms,
        *flash_bound(lb, lp, h, hkv, hd), library_ms, library_note,
        {"shape": [lb, lp, h, hkv, hd], "launches_per_prefill": 0,
         "launches_per_decode_step": 0}))
    del q, k, v, want
    d, f = cfg.d_model, cfg.d_ff
    wg, wu = (rand(gen, (d, f), bf16, d ** -0.5, device) for _ in range(2))
    wd = rand(gen, (f, d), bf16, f ** -0.5, device)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    weight_bytes = 3 * d * f * 2
    for phase, t, n_launch in (("prefill", b * p, launches["ffn_prefill"]),
                               ("decode", b, launches["ffn_decode"])):
        x = rand(gen, (t, d), bf16, device=device)
        kern = lambda: ops.ffn(x, wg, wu, wd, act=cfg.act)
        plain = lambda: ref.fused_ffn_ref(x, wg, wu, wd, act=cfg.act)
        err_rel = close(kern(), plain(), BF16_TOL, f"ffn at T {t}")
        pl = fused_ffn.plan(t, d, f, bf16, n_sm)
        # prefill: y is all it writes (no workspace, one kernel); decode: the
        # groups' f32 partials, summed in order by a second kernel
        want_ws = pl.ws_bytes == 0 if phase == "prefill" else (
            0 < pl.ws_bytes < 0.01 * weight_bytes)
        check(want_ws, f"ffn {phase}: workspace {pl.ws_bytes} B of "
              f"{weight_bytes} B of weights")
        launches, kernels = launches_per_call(kern)   # 0: not recorded
        check(launches in (0, 1 if pl.groups == 1 else 2),
              f"ffn {phase}: {launches} kernel launches per call ({kernels})")
        chain_ms = time_ms(lambda: unfused_chain(x, wg, wu, wd), 10, 3)
        say(f"[time] fused_ffn {phase} T{t}: workspace {pl.ws_bytes} B "
            f"({pl.ws_bytes / weight_bytes:.4%} of the weights), {pl.groups} "
            f"d_ff groups, kernel launches per call "
            f"{launches or 'not measured'} {kernels}; the unfused "
            f"bf16 chain (three torch.matmul, h in device memory; a "
            f"yardstick the port never calls, not one call of the same "
            f"function) {chain_ms:.6f} ms")
        rows.append(lm_row(
            f"fused_ffn[{phase} T{t} d{d} d_ff{f} gelu]", FFN_SOURCE,
            FFN_REPLACES, n_launch, err_rel, time_ms(kern, 10, 3),
            time_ms(plain, 10, 3), *ffn_bound(t, d, f), None, NO_FFN_LIBRARY,
            {"shape": [t, d, f], "launches_per_prefill":
             cfg.n_layers if phase == "prefill" else 0,
             "launches_per_decode_step": cfg.n_layers if phase == "decode"
             else 0, "ws_bytes": pl.ws_bytes, "groups": pl.groups,
             "launches_per_call": launches, "unfused_chain_ms": chain_ms}))
    return rows


def unfused_chain(x, wg, wu, wd):
    """The gated FFN as cuBLAS computes it unfused: three bf16 matmuls
    with the (T, d_ff) g, u and h in device memory, the gelu mix between."""
    g = torch.matmul(x, wg)
    h = torch.nn.functional.gelu(g, approximate="tanh") * torch.matmul(x, wu)
    return torch.matmul(h, wd)


def launches_per_call(fn, reps=3):
    """(kernel launches per ``fn()`` call, the device kernels' names) from
    torch.profiler over ``reps`` calls. Launches are the CUDA runtime's
    launch calls on the host side of the trace; (0, []) if it recorded
    none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    launches = sum(e.device_type == DeviceType.CPU
                   and e.name.startswith("cudaLaunchKernel") for e in events)
    names = {kernel_name(e.name) for e in events
             if e.device_type == DeviceType.CUDA and "emcpy" not in e.name
             and "emset" not in e.name}
    return launches / reps, sorted(names)


def kernel_name(name: str) -> str:
    """A device kernel's name without its namespace, template arguments and
    parameters."""
    m = re.search(r"(\w+)[<(]", name.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else name


def phase_lm_profile(params, device, reps=3):
    """Where a prefill's and a decode step's time goes: host-clock latency
    (unprofiled) and the device time torch.profiler records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = gemma(attn_impl="kernel", block_impl="fused")
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(device)
    max_len = LM_PROMPT + LM_GEN
    state = {}

    def do_prefill():
        state["logits"], state["cache"] = lm.prefill(params, cfg, prompts,
                                                     max_len=max_len)

    def do_decode():
        lm.decode_step(params, cfg, state["cache"], greedy(state["logits"], cfg),
                       LM_PROMPT)

    for name, fn in (("prefill", do_prefill), ("decode step", do_decode)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / reps * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        on_device = [e for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
        if not on_device:
            say(f"[lm-profile] {name}: {host_ms:.6f} ms (host clock); the "
                "profiler recorded no device time: busy share not measured")
            continue
        by_name = {}
        for e in on_device:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
        busy_ms = sum(by_name.values()) / 1e3 / reps
        say(f"[lm-profile] {name} B{LM_BATCH} P{LM_PROMPT}: {host_ms:.6f} ms "
            f"(host clock); device busy {busy_ms:.6f} ms ({busy_ms / host_ms:.2%}"
            f"), idle share {1 - busy_ms / host_ms:.2%}; "
            f"{len(on_device) // reps} device activities")
        for op, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            say(f"[lm-profile]   {us / 1e3 / reps:.6f} ms  {op[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on a card", file=sys.stderr)
        return 2
    say(card_line())
    # Both stated: the exact-integer float32 GEMMs must not run in TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    phase_build()
    net_cpu = mnv2.init_and_quantize(0, img_hw=80, device="cpu")
    phase_kernel_vs_plain(net_cpu, device)
    launches = phase_end_to_end(net_cpu, device, 256)
    check(phase_end_to_end(net_cpu, device, 1) == launches,
          "batch-1 forward launched another count")
    phase_serve(net_cpu)
    entries = []
    for batch in (256, 1):
        entries += phase_kernel_times(net_cpu, device, launches, batch)
    phase_profile(net_cpu, device)

    progs = phase_cfu_compile()
    phase_cfu_vs_golden(net_cpu, progs, device)
    cfu_counts = phase_cfu_batch(net_cpu, progs, device)
    phase_cfu_entry_point()
    phase_cfu_times(net_cpu, progs, device)
    for e in entries:
        e["launches_per_fastpath_call"] = cfu_counts

    phase_lm_kernel_vs_plain(device)
    phase_lm_end_to_end(device)
    params, _, lm_launches = phase_lm_serve(device)
    entries += phase_lm_kernel_times(device, lm_launches)
    phase_lm_profile(params, device)
    del params
    say(card_line())
    say("kernels " + json.dumps(entries))
    say(json.dumps({"kernels": entries}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
