#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths and fails (non-zero exit, no result line) on any
error: int8 MobileNetV2-VWW inference through the hand-written fused DSC
kernel, the same network compiled for the CFU and run by the CFU fast path
(whose fused and row-tile stages launch the same kernel), gemma2-9b
serving (prefill + greedy decode) through the hand-written flash-attention
and fused-FFN kernels, the CFU serving simulator, whose spot checks run
the fast path and the network on the card, the rest of the dense LM
family (qwen3-14b, glm4-9b, qwen2-72b at reduced depth and internvl2-1b
served, hubert-xlarge's forward) and the MoE, RG-LRU and RWKV6 families
(qwen2-moe-a2.7b, llama4-scout-17b-a16e at reduced depth, recurrentgemma-9b,
rwkv6-3b served) through the same two kernels, training: gradients
through both kernels and internvl2-1b trained at full width through
``launch.train`` with a restart from its checkpoint, and the multi-device
runtime (DTensor serve and train steps on a one-card mesh) with the dry
run of five full-size cells, and the dry run's live estimate held to the
card's allocator on two train steps. Phases:

1. the card's name and power limit (nvidia-smi); no CUDA device -> fail;
2. build every kernel from src/repro_torch/kernels/csrc (one nvcc each, all
   at once) and print the build time and the ptxas register/smem lines,
   with each flash and FFN kernel's registers and spill line on one line;
   the DSC kernel's registers and spill line, the count of IMMA (int8
   tensor-core) instructions in its SASS where the toolkit has
   ``cuobjdump``, and ``fused_dsc.plan`` (tile rows, units, grid, shared
   memory) for the seven blocks at batch 1 and 256 and at every batch a
   serving spot check dispatches (1..16), with the card's occupancy at
   least the plan's blocks per SM; ``fused_ffn.plan`` at gemma2-9b's and
   the wide and family archs' serve shapes, with the card's resident
   clusters (each launcher runs the plan it is handed or refuses it);
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
16. where a prefill's and a decode step's time goes (torch.profiler);
17. CFU serving: ``launch.serve_cfu.main`` at 80x80 (``--backend fast --rate
   150 --policy timeout --spot-checks 4 --batch-cap 8``), on one core and on
   two auto-hetero cores with a core dropout at 40 ms: every spot check
   bit-exact, at least one golden cross (the golden executor re-runs every
   4th fast check), 7 DSC launches per check, counted apart inside the
   fast path (7) and in the rest of the check (0: the check's reference
   ``forward_batch`` is the plain schedule on the card, so every check
   holds the kernel to an independent output), and every checked batch's
   fast-path output on the card equal to ``forward_batch`` on the CPU on
   the same frames, replayed from the checker's seed; the seconds per run,
   the host ms per fast check and per golden cross, the checked batch
   sizes;
18. host ms of one spot check at batch 1..8: fast checks on one and two
   cores, golden crosses on one core;
19. the reliability extension and the doctor through their CLIs:
   ``launch.cfu --network vww --protect --fault weights`` (every fault
   detected, verified), ``launch.cfu --network vww --doctor`` and
   ``launch.doctor --network vww`` (the categories sum to the total);
20. the new LM kernel shapes vs plain versions on the card: flash at
   hubert's (d 80, no causal mask), internvl2's (d 64, 16:2 GQA, T 768) and
   glm4's (d 128, 32:2 GQA) shapes in f32 and bf16; the bf16 FFN at d_model
   4096, 5120 and 8192 (glm4, qwen3, qwen2: d_model cut into slices of one
   cluster each) with each config's d_ff at T 4, 2048 and 1000, and in f32 at
   T 7;
21. the other dense decoders, one at a time, each at full width:
   ``launch.serve.main(["--arch", name, "--batch", "4", "--prompt-len",
   "512", "--gen", "16"])`` for qwen3-14b, glm4-9b and internvl2-1b (its
   256 patch embeddings drawn from the seed, decode positions after them)
   at full depth and qwen2-72b at 32 of its 80 layers (``--layers 32``: 145
   GB of bf16 weights do not fit one 80 GB card), every flash and FFN call
   held to its plain version; launches per prefill (n_layers flash and FFN)
   and per decode step (n_layers FFN); then the served weights: prefill and
   decode-step ms on the host clock, device busy and idle share (profiler),
   and a repeated prefill's greedy tokens equal to the served first ones;
22. hubert-xlarge at full width and depth: ``lm.forward(frames=...)`` on B 4
   x 512 seeded frames, every call held to its plain version, 48 flash and
   48 FFN launches, finite logits; the forward timed and profiled;
23. each dense arch's flash and FFN shapes timed (CUDA graph) beside the
   plain version, the bound, ``torch.compile(flex_attention)`` (flash) or the
   unfused bf16 chain (FFN), with the FFN plan's slices, resident clusters and
   the operations it does over the ones needed;
24. one summary line per dense arch: prefill ms, decode tok/s, busy, idle;
25. the MoE, RG-LRU and RWKV6 families, one at a time, each at full width,
   as phase 21: ``launch.serve.main(["--arch", name, "--batch", "4",
   "--prompt-len", "512", "--gen", "16"])`` for qwen2-moe-a2.7b,
   recurrentgemma-9b and rwkv6-3b at full depth and llama4-scout-17b-a16e at
   12 of its 48 layers (``--layers 12``: 216.5 GB of bf16 weights at 48),
   every flash and FFN call held to its plain version; launches from the
   config's layer pattern: one flash per attention layer per prefill, one
   FFN per layer per prefill and per decode step (the MoE shared expert,
   recurrentgemma's GeGLU, RWKV6's ungated relu_sq channel mix); for each
   MoE arch one line with the capacity, the assignments dropped at prefill
   and the first layer's expert-load histogram; then prefill and
   decode-step ms, busy and idle share, and a repeated prefill's greedy
   tokens equal to the served first ones;
26. each family's flash and FFN shapes timed as in phase 23 (flash with
   MQA 16:1 at d 256 under recurrentgemma's 2048 window, at 48/8 with zero
   pad heads for llama4; the FFN as a shared expert at d_model 2048 and
   5120, GeGLU at 4096, ungated relu_sq at 2560), beside the plain version,
   the bound, flex or the unfused bf16 chain;
27. one summary line per family arch, as phase 24;
28. gradients through the kernels: each of the ten smoke archs in f32 and
   bf16 compute on f32 master weights, one ``lm.loss_fn`` + backward with
   ``attn_impl="kernel"`` / ``block_impl="fused"`` (remat ``full``) against
   the same with the kernels' plain versions in their place, the MoE
   layers routed as the kernel run routed them; none missing or zero where
   the plain one is not, the launches one flash and one FFN per layer in
   the forward and again per unit layer in the remat's recompute. Held:
   every flash and FFN call of the kernel run, again on its recorded
   inputs, output and input gradients against the plain version's within
   2e-5 (f32) or 2e-2 and relative norm 1e-2 (bf16); every parameter's
   gradient within 2e-5 (f32) or a relative norm of
   ``BF16_MODEL_NORM_TOL`` (bf16, beside the control: the plain bf16
   gradient's distance from the plain f32 one);
29. training's entry point: ``launch.train.main`` on internvl2-1b at full
   width and depth (B 4, 256 seeded patch embeddings before 512 tokens, f32
   AdamW state), checkpoints every 3 steps under ``build/``, a preemption
   injected at step 4, the restart from step 3; the loss trajectory, ms per
   step, tokens/s, launches per step, and the resumed trajectory against an
   uninterrupted run from the same seed;
30. the same model under remat none | zero_buffer | full: host-clock ms
   per step, tokens/s, the device busy and idle share of a profiled step,
   peak device memory of a step, launches per step; then the FFN and flash
   kernels' forward (CUDA-graph replays) against their backward through
   the plain versions (CUDA events) at the step's shapes;
31. the multi-device runtime on this card: gemma2-9b at full width and depth
   through ``steps.build_prefill_step`` and ``build_decode_step`` on an NCCL
   (1, 1) mesh (params, batch and cache DTensors), B 4, P 512, 16 tokens:
   greedy tokens equal to the eager path's, one flash per layer per prefill
   and one FFN per layer per prefill and decode step, every launch inside
   ``local_map``; prefill and decode-step host ms beside the eager path's;
32. internvl2-1b at full width, B 4 x (256 + 512), 2 steps of the mesh
   train step on the (1, 1) mesh against the meshless step: losses within
   1e-5 relative (bit-equal reported), 24 + 24 flash and FFN launches a
   step inside ``local_map``;
33. the dry run (``launch.dryrun.run_cell``) of five full-size cells under
   the fake process group on fake ``cuda`` tensors: qwen2-72b train_4k on
   (16, 16), llama4-scout decode_32k on (2, 16, 16), gemma2-9b prefill_32k,
   gemma2-9b train_4k and rwkv6-3b long_500k on (16, 16), each ``ok`` and
   fitting one card, with its per-device argument and live bytes, FLOPs
   over model FLOPs and the bound on the H100's rates;
34. the dry run's live estimate against the card: one real train step of
   rwkv6-3b and of gemma2-9b at full width and two pattern units, at a
   train_4k microbatch's rows per device x 4096 tokens (gemma2 cut to 2
   rows: the meshless loss's whole-vocab f32 tensors), on the meshless
   path through the kernels; the card's peak allocated bytes over the
   step's arguments against ``OpCostMode.peak_live_bytes`` of the same step
   on fake ``cuda`` tensors, both printed with their ratio; an estimate
   below 0.8 of the card's reading fails.

The last stdout line is {"ok": true, "device": {...}}; the line before it is
the {"kernels": [...]} record, whose DSC rows also carry the kernel's
launches per fast-path call under each schedule and per spot check (the
fast path's and the rest of the check's, as phase 17 counted them), and
whose flash and FFN rows carry their launches per train step as counted
(phase 29; the forward's and each remat mode's, phase 30).
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
from repro_torch import tree  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import SHAPES_BY_NAME, InputShape  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.kernels import (build, flash_attention, fused_dsc,  # noqa: E402
                                 fused_ffn, ops, ref)
from repro_torch.launch import cfu as cfu_cli  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mobilenetv2 as mnv2  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.runtime import actctx  # noqa: E402
from repro_torch.runtime import steps as steps_mod  # noqa: E402

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
    # the forward's batches, and every size a serving spot check dispatches
    for batch in sorted({1, 256} | set(range(1, SERVE_MAX_BATCH + 1))):
        tiles = []
        for (name, *_), qp, hw in zip(mnv2.PAPER_BLOCKS, net.blocks,
                                      block_maps(net)):
            sp = qp.spec
            pl = fused_dsc.plan(batch, hw, hw, sp.cin, sp.cmid, sp.cout,
                                sp.stride, None, n_sm)
            occ = fused_dsc.occupancy(sp.stride, sp.cin, pl.smem_bytes)
            check(occ >= pl.blocks_per_sm,
                  f"{name} B{batch}: {occ} blocks fit per SM, the plan "
                  f"assumes {pl.blocks_per_sm}")
            tiles.append(f"{name} {pl.tile_rows} rows x {pl.units} units on "
                         f"{pl.grid} blocks ({pl.smem_bytes} B, "
                         f"{pl.blocks_per_sm}/SM, card {occ}/SM)")
        if batch in (1, 256):
            say(f"[build] fused_dsc plan B{batch}: " + "; ".join(tiles))
    say(f"[build] fused_dsc occupancy >= the plan's blocks per SM at batch "
        f"2...{SERVE_MAX_BATCH} too (the serving spot checks' sizes)")
    cfg = registry.get("gemma2-9b")
    for t in (2048, 4):
        resident = fused_ffn.max_active_clusters(t, cfg.d_model, cfg.d_ff, n_sm)
        pl = fused_ffn.plan(t, cfg.d_model, cfg.d_ff, torch.bfloat16, n_sm,
                            resident)
        say(f"[build] fused_ffn plan gemma2-9b T {t}: cluster {pl.cluster}, "
            f"{pl.cols} columns per block, chunk {pl.chunk}, {pl.stages} ring "
            f"stages, {pl.groups} d_ff groups, grid {pl.grid}, shared memory "
            f"{pl.smem_bytes} B, workspace {pl.ws_bytes} B; "
            f"{resident} clusters resident at once, so "
            f"{-(-pl.grid[1] * pl.grid[2] // resident)} waves")
    for name in WIDE_ARCHS + FAMILY_ARCHS:
        wide = registry.get(name)
        d_ff = ffn_dims(wide)[0]
        for t in (LM_BATCH * LM_PROMPT, LM_BATCH):
            resident = fused_ffn.max_active_clusters(t, wide.d_model, d_ff,
                                                     n_sm)
            pl = fused_ffn.plan(t, wide.d_model, d_ff, torch.bfloat16, n_sm,
                                resident)
            say(f"[build] fused_ffn plan {name} T {t}: {pl.slices} d_model "
                f"slices of a cluster of {pl.cluster}, {pl.cols} columns per "
                f"block, grid {pl.grid}, {pl.groups} d_ff groups, shared "
                f"memory {pl.smem_bytes} B, workspace {pl.ws_bytes} B; "
                f"{resident} clusters resident at once")


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


def host_and_device_ms(fn, reps=5, warm=3):
    """(host-clock ms per ``fn()`` call, unprofiled; device-busy ms per call
    from torch.profiler (CUPTI) or None where it records no device time;
    device activities per call; {name: device ms per call})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
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
# CFU serving: the simulator's spot checks on the card, reliability, doctor
# ---------------------------------------------------------------------------

# launch.serve_cfu at the published resolution: 150 QPS, timeout batching,
# batches of at most 8, four spot checks through the fast path on the card
# (the first a golden cross: every 4th fast check is re-run by the golden
# executor), one core and two auto-hetero cores with a core dropout
SERVE_ARGV = ["--img-hw", "80", "--backend", "fast", "--rate", "150",
              "--policy", "timeout", "--spot-checks", "4",
              "--batch-cap", "8"]
SERVE_RUNS = (("one core", []),
              ("two cores, dropout at 40 ms",
               ["--streams", "2", "--pe-per-core", "auto-hetero",
                "--dropout-at-ms", "40"]))
SERVE_SEED = 0          # serve_cfu's --seed default: weights and frames
SERVE_MAX_BATCH = 16    # build_vww_service's max_batch: sizes a check takes
# The DSC launches expected per fast spot check on a fused VWW program (one
# or two cores): 7 by the fast path, none by the rest of the check (the
# sampler's reference forward_batch is the plain schedule). Phase 17
# counts both and holds them to these.
SPOT_LAUNCHES = {"fast_path": 7, "rest": 0}


@contextlib.contextmanager
def spot_check_probe():
    """Record every spot check of a serve_cfu run: its size, whether it
    was a golden cross, its host ms, the DSC launches it made inside the
    fast path and in the rest of the check, and the fast path's frames and
    output (to hold against the CPU later). The wrappers only observe:
    they call the originals unchanged."""
    from repro_torch.cfu.serve import check as spot
    checks, fast_calls = [], []
    orig_check, orig_run_fast = spot.DifferentialSpotCheck.check, \
        fastpath.run_fast

    def run_fast(prog, x_q, params, device=None):
        n0 = fused_dsc.LAUNCHES
        y = orig_run_fast(prog, x_q, params, device=device)
        fast_calls.append({"x_q": np.array(x_q, copy=True), "y": y,
                           "launches": fused_dsc.LAUNCHES - n0})
        return y

    def timed_check(self, batch_id, size):
        n0, k0 = fused_dsc.LAUNCHES, len(fast_calls)
        t0 = time.perf_counter()
        rec = orig_check(self, batch_id, size)
        torch.cuda.synchronize()
        n = fused_dsc.LAUNCHES - n0
        fast = sum(c["launches"] for c in fast_calls[k0:])
        checks.append({"size": size, "golden_cross": rec.golden_cross,
                       "ms": (time.perf_counter() - t0) * 1e3,
                       "launches": n, "fast_path": fast, "rest": n - fast})
        return rec

    spot.DifferentialSpotCheck.check = timed_check
    fastpath.run_fast = run_fast
    try:
        yield checks, fast_calls
    finally:
        spot.DifferentialSpotCheck.check = orig_check
        fastpath.run_fast = orig_run_fast


def ms_line(checks, cross: bool) -> str:
    rows = [c for c in checks if c["golden_cross"] == cross]
    return ", ".join(f"B{c['size']} {c['ms']:.3f}" for c in rows) or "none"


def phase_cfu_serving(net_cpu, device):
    """launch.serve_cfu on the card, one core and two with a dropout: every
    spot check bit-exact, a golden cross, the DSC launches each check
    implies (counted apart in the fast path and in the rest of the check),
    and every checked batch's fast-path output equal to the CPU
    forward_batch (the DSC kernel's plain version) on the same frames.
    ``net_cpu`` is the seed-0 80x80 network serve_cfu builds itself.
    Returns the seconds, each run's launches and the per-check split."""
    from repro_torch.launch import serve_cfu
    card = card_line()
    total_s, launches, split = 0.0, [], set()
    for label, extra in SERVE_RUNS:
        argv = SERVE_ARGV + extra + ["--device", torch.device(device).type]
        out = io.StringIO()
        with spot_check_probe() as (checks, fast_calls):
            fused_dsc.LAUNCHES = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                summary = serve_cfu.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            n_launch = fused_dsc.LAUNCHES
        total_s += secs
        for line in out.getvalue().splitlines():
            say(f"[cfu-serve] {line}")
        sc = summary["spot_checks"]
        check(sc["backend"] == "fast" and sc["n_checks"] == 4,
              f"{label}: spot checks {sc}")
        check(sc["all_bit_exact"], f"{label}: a spot check diverged")
        check(sc["n_golden_cross"] >= 1, f"{label}: no golden cross")
        check(summary["drained"], f"{label}: the queue did not drain")
        per_check = sum(SPOT_LAUNCHES.values())
        got = [{k: c[k] for k in SPOT_LAUNCHES} for c in checks]
        check(n_launch == per_check * sc["n_checks"]
              and all(g == SPOT_LAUNCHES for g in got),
              f"{label}: {n_launch} DSC launches for {sc['n_checks']} checks "
              f"({got}), expected {SPOT_LAUNCHES} each")
        split.update(tuple(g.items()) for g in got)
        if extra:
            check(summary.get("n_replayed", 0) >= 1
                  and summary["device_degraded"]["n_stages"] == 1,
                  f"{label}: the dropout replayed nothing")
        # the checker's frames, replayed from its seed: every checked batch
        # the fast path ran on the card equals the CPU plain forward
        rng = np.random.default_rng(SERVE_SEED)
        check(len(fast_calls) == sc["n_checks"],
              f"{label}: {len(fast_calls)} fast-path calls")
        for size, call in zip(sc["checked_sizes"], fast_calls):
            x_q, y = call["x_q"], call["y"]
            imgs = rng.standard_normal((size, 80, 80, 3)).astype(np.float32)
            check(np.array_equal(quant.quantize(imgs, net_cpu.qp_img).numpy(),
                                 x_q), f"{label}: frame replay misaligned")
            want = mnv2.forward_batch(imgs, net_cpu, return_quantized=True)
            check(y.device.type == torch.device(device).type
                  and torch.equal(y.cpu(), want),
                  f"{label} B{size}: fast path (card) != forward_batch "
                  "(CPU plain DSC)")
        launches.append(n_launch)
        say(f"[cfu-serve] {card} {label}: {secs:.2f} s; {sc['n_checks']} "
            f"spot checks bit-exact, {sc['n_golden_cross']} golden cross, "
            f"checked sizes {sc['checked_sizes']}; {n_launch} DSC launches "
            f"(per check: {got[0]}); every checked batch == forward_batch "
            "(CPU plain DSC)")
        say(f"[cfu-serve] {card} {label}: host ms per fast check "
            f"{ms_line(checks, False)}; per golden cross "
            f"{ms_line(checks, True)}")
    (per_check,) = split            # one split in every check of both runs
    return total_s, launches, dict(per_check)


def phase_cfu_spot_times(net_cpu, device, sizes=range(1, 9), reps=3):
    """Host ms of one spot check at each batch size a capped dispatch can
    take, on the one- and two-core fused programs: fast-path checks (the
    median of ``reps``), and golden crosses on one core."""
    from repro_torch.cfu.serve.check import DifferentialSpotCheck
    card = card_line()
    params, net = vww_cfu_params(net_cpu), net_cpu.to(device)
    t_start = time.perf_counter()
    for label, kw, golden_every in (
            ("one core, fast", {}, 10**9),
            ("two cores, fast", {"streams": 2, "pe_per_core": "auto-hetero"},
             10**9),
            ("one core, golden cross", {}, 1)):
        prog = compile_vww_network(mnv2.block_specs(), 80, "fused", **kw)
        spot = DifferentialSpotCheck.for_vww(
            prog, net, params, img_hw=80, backend="fast",
            golden_every=golden_every)
        if golden_every > 1:
            spot.check(0, 1)            # the first fast check crosses
        row = []
        for size in sizes:
            times = []
            for _ in range(1 if golden_every == 1 else reps):
                t0 = time.perf_counter()
                rec = spot.check(0, size)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                cross = golden_every == 1
                check(rec.bit_exact and rec.golden_cross == cross,
                      f"{label} B{size}: {rec}")
            row.append(f"B{size} {float(np.median(times)):.3f}")
        say(f"[cfu-serve-time] {card} host ms per spot check, {label}: "
            + ", ".join(row))
    return time.perf_counter() - t_start


def phase_cfu_reliability_doctor(device):
    """launch.cfu --protect --fault weights and --doctor, and launch.doctor,
    on the VWW network: host work, run where the port is deployed."""
    from repro_torch.launch import doctor as doctor_cli
    t_start = time.perf_counter()
    for argv in (["--network", "vww", "--protect", "--fault", "weights"],
                 ["--network", "vww", "--doctor"]):
        argv = argv + ["--device", torch.device(device).type]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cfu_cli.main(argv)
        lines = out.getvalue().splitlines()
        for line in lines:
            say(f"[cfu-rel] {line}")
        row = next(ln.split(",") for ln in lines if ln.startswith("fused,"))
        check(row[-3:-1] == ["True", "True"],
              f"launch.cfu {' '.join(argv)}: verified {row[-3:-1]}")
        if "--fault" in argv:
            check(any("protect=on): detected=8" in ln for ln in lines),
                  "protected weight faults: not all 8 detected")
        else:
            check(any(ln.startswith("# cycle attribution") for ln in lines)
                  and any(ln.startswith("what_if,") for ln in lines),
                  "launch.cfu --doctor printed no attribution")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        payload = doctor_cli.main(["--network", "vww"])
    for line in out.getvalue().splitlines():
        say(f"[cfu-doctor] {line}")
    attr = payload["attribution"]
    total = 0.0
    for v in attr["categories"].values():
        total += v
    check(total == attr["total_cycles"],
          "launch.doctor: the categories do not sum to the total")
    check(len(payload["roofline"]) == 1 and payload["what_ifs"],
          "launch.doctor: no roofline point or what-if")
    secs = time.perf_counter() - t_start
    say(f"[cfu-rel] launch.cfu --protect --fault weights: every fault "
        f"detected, verified; --doctor and launch.doctor conserve; "
        f"{secs:.2f} s")
    return secs


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
# A whole bf16 smoke model's gradients, kernel run vs plain run, relative
# norm per leaf (phase 28), on an NVIDIA H100: the largest reading on sound
# runs is 7.665e-2 (gemma2-9b, the same in three runs), the control (plain
# bf16 vs plain f32) reads 1.1e-2 to 1.627e-1 (PERF.md §6, PR 21). Each
# kernel call is held to BF16_TOL and BF16_NORM_TOL on its own.
BF16_MODEL_NORM_TOL = 0.1
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


def cpu_plain(fn, *tensors, **kw):
    """A plain version on the CPU. In float32 it is computed in float64 and
    cast to float32: the card's kernel is deterministic, and the host's
    float32 products (their order of sums, and whatever precision the host's
    BLAS picks for float32) are no better a reference than the kernel's
    (probes/flash_f32_repeat.py). ``None`` arguments pass through."""
    ts = [None if t is None else t.cpu() for t in tensors]
    dtype = next(t.dtype for t in ts if t is not None)
    if dtype != torch.float32:
        return fn(*ts, **kw)
    return fn(*(None if t is None else t.double() for t in ts), **kw).float()


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
            close(got.cpu(), cpu_plain(ref.attention_ref, q, k, v, **kw), tol,
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
            close(got.cpu(), cpu_plain(ref.fused_ffn_ref, x, wg, wu, wd,
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

        def mha_checked(q, k, v, *, n_kv_heads, block=1024, **kw):
            out = mha(q, k, v, n_kv_heads=n_kv_heads, block=block, **kw)
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


def tally(by_t, fn):
    """``fn`` (an FFN call) counting its calls by token count."""
    def counted(x, *a, **kw):
        by_t[x.shape[0]] = by_t.get(x.shape[0], 0) + 1
        return fn(x, *a, **kw)
    return counted


def greedy(logits, cfg):
    return logits[:, :cfg.vocab].argmax(dim=-1)


class PlainOps:
    """Within the block, ``ops.mha`` / ``ops.ffn`` run the kernels' plain
    versions: the same function, with bf16 rounding at other places."""

    def __enter__(self):
        self.saved = (ops.mha, ops.ffn)
        ops.mha = lambda q, k, v, *, n_kv_heads, block=1024, **kw: \
            ref.mha_ref(q, k, v, **kw)
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
    for n, (p, kind, key) in enumerate(lm._layers(params, cfg)):
        x, _ = lm.layer_prefill(x, p, kind, cfg, lm._layer_cache(cache, key),
                                n)
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
    ffn_by_t, real_ffn = {}, ops.ffn
    argv = ["--arch", "gemma2-9b", "--batch", str(LM_BATCH), "--prompt-len",
            str(LM_PROMPT), "--gen", str(LM_GEN)]
    reset_lm_counts()
    ops.ffn = tally(ffn_by_t, real_ffn)
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


def flash_bound(b, p, h, hkv, d, item=2, causal=True):
    """Attention: QK^T and PV (over the lower triangle, halved, when
    causal), q, k, v and o each moved once."""
    flops = 4 * b * h * p * p * d / (2 if causal else 1)
    nbytes = item * (2 * b * p * h * d + 2 * b * p * hkv * d)
    return flops, nbytes


def ffn_bound(t, d, f, item=2, gated=True):
    """Gated FFN: three matmuls (ungated: two); x, the weights and y moved
    once."""
    n_w = 3 if gated else 2
    return 2 * n_w * t * d * f, item * (2 * t * d + n_w * d * f)


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


def flex_attention_library(q, k, v, want, *, window, softcap, causal=True):
    """The library yardstick for the flash kernel: one call of
    ``torch.compile(flex_attention)`` with the logit softcap as its
    ``score_mod``, the causal window as its block mask (none without a
    causal mask) and GQA, on the same inputs in its (B, H, T, d) layout. It
    is held to the plain version and timed here by CUDA graph; the port
    never calls it. Returns (ms or None, note)."""
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
        # each shape recompiles; past dynamo's recompile limit (8 by
        # default, and the script times more flash shapes than that) it
        # would run flex unfused
        torch._dynamo.reset()
        mask = (create_block_mask(mask_mod, None, None, p, p, device=q.device)
                if causal else None)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        flex = torch.compile(flex_attention)
        call = lambda: flex(qt, kt, vt,
                            score_mod=None if softcap is None else score_mod,
                            block_mask=mask, scale=d ** -0.5,
                            enable_gqa=h != k.shape[2])
        err, rel = close(call().transpose(1, 2), want, BF16_TOL,
                         "flex_attention at the path shape")
        ms = time_ms(call, 10, 3)
    except Exception as e:   # a yardstick that fails is recorded, not fatal
        torch.cuda.synchronize()
        return None, (f"torch {torch.__version__} flex_attention failed: "
                      f"{type(e).__name__}: {str(e)[:300]}")
    parts = [part for part, on in (
        ("softcap score_mod", softcap is not None),
        ("causal window block mask", causal), ("GQA", h != k.shape[2])) if on]
    return ms, (f"torch.compile(flex_attention), torch {torch.__version__}, "
                f"{', '.join(parts) or 'no mask'}; max |diff| {err}, "
                f"relative norm {rel:.6e} to the plain version")


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
        pl = fused_ffn.plan(t, d, f, bf16, n_sm, fused_ffn.max_active_clusters(
            t, d, f, n_sm))
        # prefill: y is all it writes (no workspace, one kernel) unless the
        # plan cuts d_ff to fill the last wave of clusters; decode: the
        # groups' f32 partials, summed in order by a second kernel
        want_ws = pl.ws_bytes == (
            4 * pl.groups * t * d if pl.groups > 1 else 0) if (
            phase == "prefill") else 0 < pl.ws_bytes < 0.01 * weight_bytes
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


CHAIN_ACTS = {"gelu": lambda g: torch.nn.functional.gelu(g, approximate="tanh"),
              "silu": torch.nn.functional.silu,
              "relu_sq": lambda g: torch.square(torch.relu(g))}


def unfused_chain(x, wg, wu, wd, act="gelu"):
    """The FFN as cuBLAS computes it unfused: three bf16 matmuls (two
    ungated, ``wg`` None) with the (T, d_ff) g, u and h in device memory,
    the mix between."""
    fn = CHAIN_ACTS[act]
    if wg is None:
        return torch.matmul(fn(torch.matmul(x, wu)), wd)
    h = fn(torch.matmul(x, wg)) * torch.matmul(x, wu)
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


# ---------------------------------------------------------------------------
# The other dense archs: qwen3-14b, glm4-9b, qwen2-72b and internvl2-1b
# served through launch.serve, hubert-xlarge's forward on frames
# ---------------------------------------------------------------------------

DENSE_DECODERS = ("qwen3-14b", "glm4-9b", "qwen2-72b", "internvl2-1b")
ENCODER = "hubert-xlarge"
DENSE_ARCHS = DENSE_DECODERS + (ENCODER,)
FAMILY_ARCHS = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e",
                "recurrentgemma-9b", "rwkv6-3b")
# qwen2-72b holds 145 GB of bf16 weights at its 80 layers: one 80 GB card
# takes 32 layers (61 GB with the embedding and the head), at full width.
# llama4-scout: 216.5 GB at 48 layers; one layer is 4.42 GB (16 experts x 3
# x 5120 x 8192, the shared expert and attention), the embedding and head
# 4.14 GB, so 12 layers are 57 GB.
DEPTH_CUT = {"qwen2-72b": (32, "80 layers are 145 GB of bf16 weights, more "
                               "than one 80 GB card; 32 layers are 61 GB"),
             "llama4-scout-17b-a16e": (
                 12, "48 layers are 216.5 GB of bf16 weights; one layer is "
                     "4.42 GB (16 experts x 3 x 5120 x 8192, the shared "
                     "expert and attention), the embedding and head 4.14 "
                     "GB, so 12 layers are 57 GB")}
# The new flash shapes, held to the plain version in f32 and bf16:
# (name, b, t, h, hkv, d, causal)
DENSE_FLASH_CHECKS = [("hubert d80 non-causal", 4, 512, 16, 16, 80, False),
                      ("internvl2 d64 16:2 T768", 4, 768, 16, 2, 64, True),
                      ("glm4 d128 32:2", 4, 512, 32, 2, 128, True)]
WIDE_ARCHS = ("glm4-9b", "qwen3-14b", "qwen2-72b")   # d_model past 3584


def dense_cfg(name):
    """The arch at the depth the card runs, with the kernel disciplines."""
    full = registry.get(name)
    layers = DEPTH_CUT.get(name, (full.n_layers, None))[0]
    return dataclasses.replace(full, n_layers=layers, attn_impl="kernel",
                               block_impl="fused")


def prefix_len(cfg) -> int:
    return cfg.n_patches if cfg.frontend == "vision" else 0


def ffn_dims(cfg):
    """(d_ff, gated, act) of the arch's fused-FFN calls: the MoE shared
    expert's, RWKV6's channel mix (ungated relu_sq), else the FFN's."""
    if cfg.moe is not None:
        return cfg.moe.shared_d_ff, cfg.gated, cfg.act
    if "rwkv" in cfg.pattern:
        return cfg.d_ff, False, "relu_sq"
    return cfg.d_ff, cfg.gated, cfg.act


def launches_per_pass(cfg):
    """(flash, FFN) launches of one prefill, from the layer pattern: one
    flash per attention layer, one FFN per layer with an FFN-shaped second
    half (a decode step launches the same FFN count and no flash)."""
    kinds = cfg.layer_kinds()
    flash = sum(k in lm.ATTN_KINDS for k in kinds)
    has_ffn = cfg.moe is None or cfg.moe.shared_d_ff > 0
    ffn = sum(k == "rwkv" or has_ffn for k in kinds)
    return flash, ffn


def describe(cfg) -> str:
    """The arch's layers and widths, for a phase's first line."""
    kinds = cfg.layer_kinds()
    parts = [f"d_model {cfg.d_model}"]
    if any(k in lm.ATTN_KINDS for k in kinds):
        parts.append(f"{cfg.n_heads_padded} query ({cfg.n_heads} + "
                     f"{cfg.head_pad} pad) / {cfg.n_kv_heads} KV heads of "
                     f"{cfg.head_dim_}" + (f", window {cfg.window}"
                                           if "attn_local" in kinds else ""))
    if "recurrent" in kinds:
        parts.append(f"pattern {cfg.pattern} x {cfg.n_units} + tail "
                     f"{cfg.tail_kinds}, RG-LRU width {cfg.lru_width_}, "
                     f"conv {cfg.conv_width}")
    if "rwkv" in kinds:
        parts.append(f"{cfg.n_rwkv_heads} WKV heads of {cfg.rwkv_head_dim}")
    if cfg.moe is not None:
        m = cfg.moe
        parts.append(f"{m.n_experts} experts top-{m.top_k} of d_ff "
                     f"{m.d_ff_expert}, shared expert d_ff {m.shared_d_ff}, "
                     f"capacity factor {m.capacity_factor}")
    d_ff, gated, act = ffn_dims(cfg)
    parts.append(f"fused FFN d_ff {d_ff} {act}"
                 + ("" if gated else " ungated"))
    return ", ".join(parts)


def ffn_work_factor(t, d, f, gated, n_sm):
    """The operations the bf16 plan does over the ones the FFN needs: the
    expansion once per d_model slice, the projection over every block's
    columns (T's padding to 64 rows not counted)."""
    pl = fused_ffn.plan(t, d, f, torch.bfloat16, n_sm,
                        fused_ffn.max_active_clusters(t, d, f, n_sm))
    exp = (2 if gated else 1) * d
    return (pl.slices * exp + pl.grid[0] * pl.cols) / (exp + d)


def phase_dense_kernel_vs_plain(device):
    """The new shapes of both LM kernels against their plain versions on the
    card: flash at hubert's, internvl2's and glm4's shapes in f32 and bf16;
    the FFN at d_model 4096, 5120 and 8192 with each config's d_ff, at T 4,
    2048 and a ragged 1000 in bf16, and at T 7 in f32."""
    gen = torch.Generator(device=device).manual_seed(41)
    n, worst = 0, 0.0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for name, b, t, h, hkv, d, causal in DENSE_FLASH_CHECKS:
            q = rand(gen, (b, t, h, d), dtype, device=device)
            k, v = (rand(gen, (b, t, hkv, d), dtype, device=device)
                    for _ in range(2))
            got = ops.mha(q, k, v, n_kv_heads=hkv, causal=causal)
            _, rel = close(got, ref.mha_ref(q, k, v, causal=causal), tol,
                           f"flash {name} {dtype}")
            worst = max(worst, rel) if dtype == torch.bfloat16 else worst
            n += 1
    say(f"[dense-kernel] flash_attention == mha_ref on {n} new shapes "
        f"({', '.join(c[0] for c in DENSE_FLASH_CHECKS)}; f32 2e-5, bf16 2e-2 "
        f"and relative norm < {BF16_NORM_TOL}: largest bf16 relative norm "
        f"{worst:.6e})")
    n, worst = 0, 0.0
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    for name in WIDE_ARCHS:
        cfg = registry.get(name)
        d, f = cfg.d_model, cfg.d_ff
        cases = [(torch.bfloat16, BF16_TOL, (4, 2048, 1000))]
        if name == WIDE_ARCHS[-1]:
            cases.append((torch.float32, F32_TOL, (7,)))
        for dtype, tol, ts in cases:
            wg, wu = (rand(gen, (d, f), dtype, d ** -0.5, device)
                      for _ in range(2))
            wd = rand(gen, (f, d), dtype, f ** -0.5, device)
            for t in ts:
                x = rand(gen, (t, d), dtype, device=device)
                got = ops.ffn(x, wg, wu, wd, act=cfg.act)
                _, rel = close(got, ref.fused_ffn_ref(x, wg, wu, wd,
                                                      act=cfg.act), tol,
                               f"ffn {name} T{t} {dtype}")
                worst = max(worst, rel) if dtype == torch.bfloat16 else worst
                n += 1
            del wg, wu, wd
        pl = fused_ffn.plan(2048, d, f, torch.bfloat16, n_sm,
                            fused_ffn.max_active_clusters(2048, d, f, n_sm))
        say(f"[dense-kernel] fused_ffn {name} d_model {d} d_ff {f}: "
            f"{pl.slices} slices of a cluster of {pl.cluster}, "
            f"{pl.cols} columns per block; the plan does "
            f"{ffn_work_factor(2048, d, f, True, n_sm):.4f}x the FFN's "
            f"operations")
    torch.cuda.empty_cache()
    say(f"[dense-kernel] fused_ffn == fused_ffn_ref on {n} wide shapes (f32 "
        f"2e-5, bf16 2e-2 and relative norm < {BF16_NORM_TOL}: largest bf16 "
        f"relative norm {worst:.6e})")


def time_path(tag, fns, reps):
    """Host-clock ms (unprofiled) and device-busy ms (torch.profiler) per
    call of each (name, fn); returns {name: (host_ms, busy_ms)}."""
    out = {}
    for name, fn in fns:
        host_ms, busy_ms, n_act, by_name = host_and_device_ms(fn, reps, 1)
        out[name] = (host_ms, busy_ms)
        say(f"[{tag}] {name}: {busy_line(host_ms, busy_ms, n_act)}")
        for op, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:4]:
            say(f"[{tag}]   {ms:.6f} ms  {op[:90]}")
    return out


class MoELoad:
    """Within the block, every ``moe.moe_layer`` call on more than one
    token per sequence (the prefill) also records ``moe.expert_load`` on
    its input: the capacity, the assignments dropped past it and each
    expert's load. It recomputes the routing and launches no kernel."""

    def __init__(self):
        self.calls, self.saved = [], None

    def __enter__(self):
        self.saved = moe.moe_layer

        def recorded(x, p, cfg, layer=None):
            if x.shape[1] > 1:
                self.calls.append(moe.expert_load(x, p, cfg))
            return self.saved(x, p, cfg, layer)

        moe.moe_layer = recorded
        return self

    def __exit__(self, *exc):
        moe.moe_layer = self.saved


def phase_arch_serve(name, device, tag="dense"):
    """One decoder through the user's entry point: ``launch.serve --arch
    name`` (``--layers`` where the card cannot hold the full depth) at B 4,
    P 512, 16 generated tokens, every flash and FFN call held to its plain
    version; the launches per prefill and per decode step, from the layer
    pattern (``launches_per_pass``); for MoE, the dispatch at prefill; then
    the served weights timed: a prefill and a decode step on the host
    clock, and the device-busy time of a profiled repeat. Returns the
    launch counts and times."""
    cfg = dense_cfg(name)
    full_layers = registry.get(name).n_layers
    layers, off = cfg.n_layers, prefix_len(cfg)
    cut = DEPTH_CUT.get(name, (None, None))[1]
    say(f"[{tag}] {name}: {layers} of {full_layers} layers ("
        + (f"depth cut: {cut}" if cut else "full depth")
        + f"), full width: {describe(cfg)}; {card_line()}")
    argv = ["--arch", name, "--batch", str(LM_BATCH), "--prompt-len",
            str(LM_PROMPT), "--gen", str(LM_GEN)]
    if layers != full_layers:
        argv += ["--layers", str(layers)]
    held, by_t = {}, {}
    real_init = lm.init_params

    def keep(*a, **kw):
        held["params"] = real_init(*a, **kw)
        return held["params"]

    t0 = time.perf_counter()
    with Checked(BF16_TOL) as chk, MoELoad() as moe_load:
        ops.ffn = tally(by_t, ops.ffn)
        lm.init_params = keep
        try:
            reset_lm_counts()
            gen_tokens = serve.main(argv)
            torch.cuda.synchronize()
            flash_n, ffn_n = lm_counts()
        finally:
            lm.init_params = real_init
    serve_s = time.perf_counter() - t0
    t_pre = LM_BATCH * (off + LM_PROMPT)
    n_flash, n_ffn = launches_per_pass(cfg)
    counts = {"flash": flash_n, "ffn_prefill": by_t.get(t_pre, 0),
              "ffn_decode": by_t.get(LM_BATCH, 0)}
    want = {"flash": n_flash, "ffn_prefill": n_ffn,
            "ffn_decode": n_ffn * (LM_GEN - 1)}
    check(counts == want and ffn_n == n_ffn * LM_GEN,
          f"{name}: serve launched {counts} (ffn {ffn_n}, by T {by_t}), "
          f"expected {want}")
    check(gen_tokens.shape == (LM_BATCH, LM_GEN)
          and 0 <= gen_tokens.min() and gen_tokens.max() < cfg.vocab,
          f"{name}: served tokens {gen_tokens.shape}")
    say(f"[{tag}] {name} served in {serve_s:.3f} s (seeding and the plain "
        f"checks included): launches (flash, ffn) ({flash_n}, {ffn_n}): "
        f"{n_flash} flash and {n_ffn} FFN per prefill (FFN T {t_pre}), "
        f"{n_ffn} FFN per decode step x {LM_GEN - 1}; every call within "
        f"{BF16_TOL} of its plain version and relative norm "
        f"{BF16_NORM_TOL} (max |diff| flash {chk.errs['flash']}, ffn "
        f"{chk.errs['ffn']}; relative norm flash {chk.rels['flash']:.6e}, "
        f"ffn {chk.rels['ffn']:.6e})")
    if cfg.moe is not None:
        loads = moe_load.calls
        check(len(loads) == layers, f"{name}: {len(loads)} MoE prefill "
              f"calls recorded, expected {layers}")
        first = loads[0]
        check(sum(first["load"]) == t_pre * cfg.moe.top_k,
              f"{name}: expert loads {first['load']}")
        dropped = sum(c["dropped"] for c in loads)
        say(f"[{tag}] {name} MoE dispatch at prefill (T {t_pre}): capacity "
            f"{first['capacity']} per expert; {dropped} of "
            f"{t_pre * cfg.moe.top_k * layers} assignments dropped over "
            f"{layers} layers ({first['dropped']} in the first); first "
            f"layer's expert load {first['load']}")

    params = held.pop("params")
    rng = np.random.default_rng(0)   # serve's --seed: its prompts, patches
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(device)
    patches = (torch.from_numpy(rng.standard_normal(
        (LM_BATCH, off, cfg.d_model)).astype(np.float32)).to(device) * 0.02
        if off else None)
    state = {}

    def do_prefill():
        state["logits"], state["cache"] = lm.prefill(
            params, cfg, prompts, patches=patches,
            max_len=off + LM_PROMPT + LM_GEN)

    def do_decode():
        lm.decode_step(params, cfg, state["cache"],
                       greedy(state["logits"], cfg), off + LM_PROMPT)

    times = time_path(f"{tag} {name}", (("prefill", do_prefill),
                                        ("decode step", do_decode)), 2)
    check(np.array_equal(greedy(state["logits"], cfg).cpu().numpy(),
                         gen_tokens[:, 0]),
          f"{name}: a repeated prefill's greedy tokens != the served first "
          "tokens")
    del params, state
    torch.cuda.empty_cache()
    return {"layers": layers, "full_layers": full_layers, "counts": counts,
            "per_pass": {"flash": n_flash, "ffn": n_ffn}, "t_prefill": t_pre,
            "times": times}


def phase_encoder_forward(device):
    """hubert-xlarge at full width and depth: ``lm.forward`` on B 4 x 512
    seeded frames, every flash (non-causal, d 80) and FFN (ungated gelu)
    call held to its plain version; 48 of each per forward; then the
    forward timed on the host clock and profiled."""
    cfg = dense_cfg(ENCODER)
    layers = cfg.n_layers
    say(f"[dense] {ENCODER}: {layers} layers (full depth), full width: "
        f"d_model {cfg.d_model}, d_ff {cfg.d_ff} ungated {cfg.act}, "
        f"{cfg.n_heads} heads of {cfg.head_dim_}, causal {cfg.causal}; "
        f"{card_line()}")
    params = lm.init_params(cfg, 0, device)
    frames = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (LM_BATCH, LM_PROMPT, cfg.d_model)).astype(np.float32)).to(device)
    by_t = {}
    with Checked(BF16_TOL) as chk:
        ops.ffn = tally(by_t, ops.ffn)
        reset_lm_counts()
        logits = lm.forward(params, cfg, frames=frames)
        torch.cuda.synchronize()
        counts = lm_counts()
    t = LM_BATCH * LM_PROMPT
    check(counts == (layers, layers) and by_t == {t: layers},
          f"{ENCODER}: forward launched (flash, ffn) {counts}, by T {by_t}")
    check(logits.shape == (LM_BATCH, LM_PROMPT, cfg.vocab_padded())
          and bool(torch.isfinite(logits).all()),
          f"{ENCODER}: logits {tuple(logits.shape)} not finite or wrong shape")
    say(f"[dense] {ENCODER} forward B{LM_BATCH} T{LM_PROMPT}: launches (flash, "
        f"ffn) {counts}; every call within {BF16_TOL} of its plain version "
        f"(max |diff| flash {chk.errs['flash']}, ffn {chk.errs['ffn']}; "
        f"relative norm flash {chk.rels['flash']:.6e}, ffn "
        f"{chk.rels['ffn']:.6e}); logits finite")
    times = time_path(f"dense {ENCODER}", (
        ("forward", lambda: lm.forward(params, cfg, frames=frames)),), 2)
    del params, logits
    torch.cuda.empty_cache()
    return {"layers": layers, "full_layers": layers, "t_prefill": t,
            "counts": {"flash": counts[0], "ffn_prefill": counts[1],
                       "ffn_decode": 0},
            "per_pass": {"flash": layers, "ffn": layers}, "times": times}


def phase_dense_kernel_times(device, runs, names=DENSE_ARCHS, seed=51):
    """Each arch's flash and FFN shapes (bf16): CUDA-graph time, the plain
    version's, the bound; flash beside ``torch.compile(flex_attention)``,
    the FFN beside the unfused bf16 chain. Launches are the model phases'
    counts. An arch without attention layers (rwkv6) has no flash row; a
    local-attention arch's flash row has its window."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bf16 = torch.bfloat16
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for name in names:
        cfg, run = dense_cfg(name), runs[name]
        b, t = LM_BATCH, prefix_len(cfg) + LM_PROMPT
        per = run["per_pass"]
        if per["flash"]:
            h, hkv, hd = cfg.n_heads_padded, cfg.n_kv_heads, cfg.head_dim_
            window = cfg.window if "attn_local" in cfg.pattern else None
            q = rand(gen, (b, t, h, hd), bf16, device=device)
            k, v = (rand(gen, (b, t, hkv, hd), bf16, device=device)
                    for _ in range(2))
            kw = dict(causal=cfg.causal, window=window)
            kern = lambda: ops.mha(q, k, v, n_kv_heads=hkv, **kw)
            plain = lambda: ref.mha_ref(q, k, v, **kw)
            want = plain()
            err_rel = close(kern(), want, BF16_TOL, f"flash {name}")
            ms, plain_ms = time_ms(kern, 10, 3), time_ms(plain, 10, 3)
            library_ms, library_note = flex_attention_library(
                q, k, v, want, window=window, softcap=None,
                causal=cfg.causal)
            rows.append(lm_row(
                f"flash_attention[{name} prefill B{b} P{t} H{h}/{hkv} d{hd}"
                f"{'' if cfg.causal else ' non-causal'}"
                f"{f' window {window}' if window else ''}]", FLASH_SOURCE,
                FLASH_REPLACES, run["counts"]["flash"], err_rel, ms,
                plain_ms, *flash_bound(b, t, h, hkv, hd, causal=cfg.causal),
                library_ms, library_note,
                {"shape": [b, t, h, hkv, hd], "arch": name,
                 "launches_per_prefill": per["flash"],
                 "launches_per_decode_step": 0}))
            del q, k, v, want
        d = cfg.d_model
        f, gated, act = ffn_dims(cfg)
        wg = rand(gen, (d, f), bf16, d ** -0.5, device) if gated else None
        wu = rand(gen, (d, f), bf16, d ** -0.5, device)
        wd = rand(gen, (f, d), bf16, f ** -0.5, device)
        phases = [("prefill", run["t_prefill"], run["counts"]["ffn_prefill"])]
        if name != ENCODER:
            phases.append(("decode", b, run["counts"]["ffn_decode"]))
        for phase, tt, n_launch in phases:
            x = rand(gen, (tt, d), bf16, device=device)
            kern = lambda: ops.ffn(x, wg, wu, wd, act=act)
            plain = lambda: ref.fused_ffn_ref(x, wg, wu, wd, act=act)
            err_rel = close(kern(), plain(), BF16_TOL, f"ffn {name} T {tt}")
            resident = fused_ffn.max_active_clusters(tt, d, f, n_sm)
            pl = fused_ffn.plan(tt, d, f, bf16, n_sm, resident)
            chain_ms = time_ms(lambda: unfused_chain(x, wg, wu, wd, act),
                               10, 3)
            factor = ffn_work_factor(tt, d, f, gated, n_sm)
            clusters = pl.slices * pl.grid[1] * pl.grid[2]
            waves = -(-clusters // max(resident, 1))
            say(f"[time] fused_ffn {name} {phase} T{tt}: {pl.slices} d_model "
                f"slices, cluster {pl.cluster}, {pl.cols} columns per block, "
                f"grid {pl.grid}, {pl.groups} d_ff groups, workspace "
                f"{pl.ws_bytes} B; {resident} clusters resident, {waves} "
                f"waves; {factor:.4f}x the FFN's operations; the unfused bf16 "
                f"chain (a yardstick the port never calls) {chain_ms:.6f} ms")
            role = ("shared expert " if cfg.moe is not None else
                    "channel mix " if "rwkv" in cfg.pattern else "")
            rows.append(lm_row(
                f"fused_ffn[{name} {role}{phase} T{tt} d{d} d_ff{f} {act}"
                f"{'' if gated else ' ungated'}]", FFN_SOURCE,
                FFN_REPLACES, n_launch, err_rel, time_ms(kern, 10, 3),
                time_ms(plain, 10, 3),
                *ffn_bound(tt, d, f, gated=gated), None, NO_FFN_LIBRARY,
                {"shape": [tt, d, f], "arch": name,
                 "launches_per_prefill": per["ffn"]
                 if phase == "prefill" else 0,
                 "launches_per_decode_step": per["ffn"]
                 if phase == "decode" else 0,
                 "slices": pl.slices, "cluster": pl.cluster,
                 "cols": pl.cols, "groups": pl.groups,
                 "ws_bytes": pl.ws_bytes, "work_factor": factor,
                 "resident_clusters": resident,
                 "unfused_chain_ms": chain_ms}))
            del x
        del wg, wu, wd
        torch.cuda.empty_cache()
    return rows


def dense_summary(runs, tag="dense-summary"):
    """One line per arch of ``runs``: prefill ms, decode tok/s, busy,
    idle."""
    card = card_line()
    for name, run in runs.items():
        for step, (host_ms, busy_ms) in run["times"].items():
            rate = (f", {LM_BATCH / host_ms * 1e3:.3f} tok/s"
                    if step == "decode step" else "")
            busy = ("busy not measured" if busy_ms is None else
                    f"busy {busy_ms:.6f} ms, idle share "
                    f"{1 - busy_ms / host_ms:.2%}")
            say(f"[{tag}] {name} ({run['layers']} of "
                f"{run['full_layers']} layers) {step} B{LM_BATCH}: "
                f"{host_ms:.6f} ms host clock{rate}; {busy}; launches "
                f"{run['counts']}; {card}")


# ---------------------------------------------------------------------------
# Training (phases 28-30)
# ---------------------------------------------------------------------------

TRAIN_ARCH = "internvl2-1b"
TRAIN_BATCH, TRAIN_SEQ = 4, 512
GRAD_B, GRAD_T = 2, 64


def train_launches(cfg):
    """(flash, FFN) launches of one ``loss_fn`` + backward: one per layer in
    the forward, and one more per pattern-unit layer where the remat
    recomputes it in the backward pass (``full``: the whole unit;
    ``zero_buffer``: its attention and FFN cores); the tail is not
    rematerialized, as in the reference."""
    fwd = launches_per_pass(cfg)
    if cfg.remat == "none":
        return fwd
    units = dataclasses.replace(cfg, n_layers=cfg.n_units * len(cfg.pattern))
    again = launches_per_pass(units)
    return fwd[0] + again[0], fwd[1] + again[1]


def train_batch(cfg, rng, b=GRAD_B, t=GRAD_T):
    """A seeded numpy batch: tokens (and patches) or frames, and labels."""
    batch = {}
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal(
            (b, t, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, t))
        if cfg.frontend == "vision":
            batch["patches"] = (rng.standard_normal(
                (b, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)
    batch["labels"] = rng.integers(0, cfg.vocab, (b, t))
    return batch


class Routes:
    """Within the block, records the expert ids of every MoE routing; given
    ``replay`` (the ids a kernel run recorded, in call order), routes each
    call to those ids instead, its gates the run's own router
    probabilities there, and counts the token choices its own top-k would
    have made otherwise."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        self.ids, self.saved, self.flips = [], moe._route, 0

        def routed(xf, p, m):
            probs, gates, ids = self.saved(xf, p, m)
            if self.replay is not None:
                own, ids = ids, self.replay[len(self.ids)]
                self.flips += int((own != ids).any(dim=-1).sum())
                gates = probs.gather(-1, ids)
                if m.top_k > 1:
                    gates = gates / gates.sum(dim=-1, keepdim=True)
            self.ids.append(ids.detach().clone())
            return probs, gates, ids

        moe._route = routed
        return self

    def __exit__(self, *exc):
        moe._route = self.saved


class Calls:
    """Within the block, records every ``ops.ffn`` / ``ops.mha`` call: its
    name, detached copies of its tensors, and its keywords."""

    def __enter__(self):
        self.calls, self.saved = [], (ops.mha, ops.ffn)

        def recorder(name, fn):
            def call(*args, **kw):
                self.calls.append((name, [None if a is None else
                                          a.detach().clone() for a in args],
                                   kw))
                return fn(*args, **kw)
            return call

        ops.mha, ops.ffn = recorder("mha", ops.mha), recorder("ffn", ops.ffn)
        return self

    def __exit__(self, *exc):
        ops.mha, ops.ffn = self.saved


def hold_calls(calls, tol, what, gen):
    """Each recorded call again, through the kernel's differentiable launch
    and through its plain version on the same inputs: the outputs, and the
    gradients of both for one seeded output gradient, held within ``tol``
    (bf16 also by relative norm). Returns the largest relative norms of
    the outputs and of the gradients."""
    worst_out = worst_grad = 0.0
    for n, (name, args, kw) in enumerate(calls):
        if name == "ffn":
            fn, plain, plain_kw = ops.ffn, ref.fused_ffn_ref, kw
        else:
            fn, plain = ops.mha, ref.mha_ref
            plain_kw = {k: v for k, v in kw.items()
                        if k not in ("n_kv_heads", "block")}
        live = [i for i, a in enumerate(args) if a is not None]
        a_k = [None if a is None else a.clone().requires_grad_()
               for a in args]
        a_p = [None if a is None else a.clone().requires_grad_()
               for a in args]
        out_k, out_p = fn(*a_k, **kw), plain(*a_p, **plain_kw)
        rel = close(out_k.detach(), out_p.detach(), tol,
                    f"{what} {name} call {n} output")[1]
        worst_out = max(worst_out, rel)
        g = rand(gen, out_p.shape, out_p.dtype)
        gk = torch.autograd.grad(out_k, [a_k[i] for i in live], g)
        gp = torch.autograd.grad(out_p, [a_p[i] for i in live], g)
        for i, x, y in zip(live, gk, gp):
            rel = close(x, y, tol, f"{what} {name} call {n} input {i} "
                        f"gradient")[1]
            worst_grad = max(worst_grad, rel)
    return worst_out, worst_grad


def loss_and_grads(cfg, params, batch):
    loss, _ = lm.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, tree.leaves(params), allow_unused=True)
    torch.cuda.synchronize()
    return float(loss.detach()), grads


def phase_train_grads(device):
    """Each smoke arch in f32 and bf16 compute (f32 master weights): one
    ``loss_fn`` + backward through the kernels (``attn_impl="kernel"``,
    ``block_impl="fused"``, remat ``full``) and one with the kernels' plain
    versions in their place (``PlainOps``), the MoE layers routed to the
    kernel run's expert ids (``Routes``); no gradient missing or zero where
    the plain one is not, and the launches counted. Held:

    * every flash and FFN call of the kernel run, again on its recorded
      inputs: output and gradients against the plain version's, within
      2e-5 in f32, 2e-2 and a relative norm of 1e-2 in bf16;
    * every parameter's gradient against the plain run's: in f32 within
      2e-5; in bf16 within a relative norm of ``BF16_MODEL_NORM_TOL``. A
      bf16 model carries each rounding through its depth, so two sound
      bf16 paths differ far more than one call does (PERF.md §6, PR 21);
      the plain bf16 gradient's distance from the plain f32 one, the
      control, is printed beside.

    Every arch is printed before the limits are applied."""
    t0 = time.perf_counter()
    failed = []
    gen = torch.Generator(device=device).manual_seed(28)
    for name in registry.ARCH_NAMES:
        for dtype, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
            what = f"{name} {dtype}"
            cfg = dataclasses.replace(
                registry.get_smoke(name), dtype=dtype, attn_impl="kernel",
                block_impl="fused")
            params = lm.init_params(cfg, 5, device, torch.float32)
            for p in tree.leaves(params):
                p.requires_grad_(True)
            batch = train_batch(cfg, np.random.default_rng(5))
            with Routes() as k_routes, Calls() as calls:
                reset_lm_counts()
                k_loss, k_grads = loss_and_grads(cfg, params, batch)
                counts = lm_counts()
            want = train_launches(cfg)
            check(counts == want and len(calls.calls) == sum(counts),
                  f"{what}: loss + backward launched (flash, ffn) {counts} "
                  f"in {len(calls.calls)} calls, expected {want}")
            with Routes(k_routes.ids) as p_routes, PlainOps():
                reset_lm_counts()
                p_loss, p_grads = loss_and_grads(cfg, params, batch)
                check(lm_counts() == (0, 0), "the plain run launched")
            f_grads = p_grads
            if dtype == "bfloat16":
                with Routes(k_routes.ids), PlainOps():
                    _, f_grads = loss_and_grads(
                        dataclasses.replace(cfg, dtype="float32"), params,
                        batch)
            if abs(k_loss - p_loss) > tol * max(1.0, abs(p_loss)):
                failed.append(f"{what}: loss {k_loss} vs plain {p_loss}")
            worst_err, worst_rel, worst_leaf, control = 0.0, 0.0, "", 0.0
            for (path, _), g, w, f in zip(tree.flatten_with_path(params),
                                          k_grads, p_grads, f_grads):
                check(g is not None and w is not None,
                      f"{what}: {path} has no gradient")
                check(bool((g != 0).any()) or not bool((w != 0).any()),
                      f"{what}: {path}'s gradient is zero through the "
                      f"kernels, not in the plain run")
                err, rel = max_err(g, w), rel_norm(g, w)
                if rel >= worst_rel:
                    worst_rel, worst_leaf = rel, path
                worst_err, control = max(worst_err, err), max(
                    control, rel_norm(w, f))
                ok = (bool(torch.allclose(g, w, atol=tol, rtol=tol))
                      if dtype == "float32" else rel < BF16_MODEL_NORM_TOL)
                if not ok:
                    failed.append(f"{what}: {path} gradient through the "
                                  f"kernels vs plain: max |diff| {err}, "
                                  f"relative norm {rel}")
            call_out, call_grad = hold_calls(calls.calls, tol, what, gen)
            routes = ("" if not k_routes.ids else
                      f" the plain run replayed the kernel run's MoE routing "
                      f"({p_routes.flips} of "
                      f"{sum(len(i) for i in k_routes.ids)} token choices "
                      f"its own router would have made otherwise);")
            limit = (f"tol {tol}" if dtype == "float32" else
                     f"relative norm tol {BF16_MODEL_NORM_TOL}; control: the "
                     f"plain bf16 gradients' largest relative norm from f32 "
                     f"{control:.3e}")
            say(f"[train-grads] {what}: loss {k_loss:.6f} (plain "
                f"{p_loss:.6f}); launches (flash, ffn) {counts};{routes} "
                f"{len(k_grads)} gradients, max |diff| {worst_err:.3e}, "
                f"largest relative norm {worst_rel:.3e} ({worst_leaf}; "
                f"{limit}); {len(calls.calls)} kernel calls again on their "
                f"inputs: largest relative norm output {call_out:.3e}, "
                f"gradients {call_grad:.3e} (tol {tol}"
                f"{'' if dtype == 'float32' else f', {BF16_NORM_TOL}'})")
            del params, k_grads, p_grads, f_grads, calls
    check(not failed, "; ".join(failed))
    say(f"[train-grads] phase 28: {time.perf_counter() - t0:.2f} s")


def phase_train_entry(device):
    """``launch.train`` at internvl2-1b's full width and depth (256 seeded
    patch embeddings before 512 tokens, B 4), checkpoints every 3 steps, a
    preemption injected at step 4 (one past the checkpoint), restart from
    it; the resumed trajectory against an uninterrupted run from the same
    seed. Returns (flash, FFN) launches per train step."""
    cfg = dataclasses.replace(registry.get(TRAIN_ARCH), attn_impl="kernel",
                              block_impl="fused")
    n_steps, period, fail_at, lr, warmup = 5, 3, 4, 3e-4, 1
    ckpt_dir = Path(__file__).resolve().parent / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    argv = ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
            str(TRAIN_SEQ), "--steps", str(n_steps), "--lr", str(lr),
            "--warmup", str(warmup), "--ckpt-dir", str(ckpt_dir),
            "--ckpt-period", str(period), "--inject-failure-at", str(fail_at)]
    say(f"[train] launch.train {' '.join(argv)}")
    reset_lm_counts()
    t0 = time.perf_counter()
    rep = train_cli.main(argv)
    wall = time.perf_counter() - t0
    counts = lm_counts()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    hist = rep.metrics_history
    check(rep.restarts == 1 and rep.final_step == n_steps
          and [m["step"] for m in hist] == [0, 1, 2, 3, 3, 4],
          f"driver: restarts {rep.restarts}, steps "
          f"{[m['step'] for m in hist]}")
    per_step = (counts[0] // len(hist), counts[1] // len(hist))
    check(counts == (per_step[0] * len(hist), per_step[1] * len(hist))
          and per_step == train_launches(cfg),
          f"launch.train launched (flash, ffn) {counts} in {len(hist)} "
          f"steps, expected {train_launches(cfg)} per step")
    losses = [m["loss"] for m in hist]
    check(all(np.isfinite(losses)), f"losses {losses}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = [m["dt"] for m in hist[1:]]
    say(f"[train] {TRAIN_ARCH}: {cfg.param_count():,} params, f32 AdamW "
        f"state, {cfg.dtype} compute, remat {cfg.remat}; {rep.steps_run} "
        f"steps and {rep.restarts} restart in {wall:.3f} s")
    say(f"[train] loss trajectory (step: loss, ms): " + ", ".join(
        f"{m['step']}: {m['loss']:.6f} {m['dt'] * 1e3:.3f}" for m in hist))
    say(f"[train] launches per train step (flash, ffn) {per_step}, "
        f"counted over the {len(hist)} steps run (remat {cfg.remat}: the "
        f"forward's and the recompute's in the backward); steps after the "
        f"first: "
        f"{np.median(steady) * 1e3:.3f} ms median, "
        f"{tokens / np.median(steady):.1f} tokens/s ({tokens} text tokens "
        f"a step, {TRAIN_BATCH * (TRAIN_SEQ + cfg.n_patches)} positions); "
        f"{card_line()}")

    # the same run without the preemption
    shape = InputShape("train_cli", TRAIN_SEQ, TRAIN_BATCH, "train")
    train = steps_mod.TrainSpec(peak_lr=lr, warmup_steps=warmup,
                                total_steps=n_steps)
    step = steps_mod.build_train_step(cfg, train, shape, device)
    state = steps_mod.init_train_state(cfg, 0, train, device)
    data = SyntheticLMData(cfg, shape, seed=0)
    straight = []
    for i in range(n_steps):
        state, m = step(state, data.batch_at(i))
        straight.append(float(m["loss"]))
    del state
    torch.cuda.empty_cache()
    resumed = losses[:4] + losses[5:]
    diff = max(abs(a - b) for a, b in zip(resumed, straight))
    replay = abs(losses[3] - losses[4])
    check(diff <= 1e-4 and replay <= 1e-4,
          f"resumed losses {resumed} vs uninterrupted {straight}")
    say(f"[train] resumed trajectory vs uninterrupted run: "
        f"{'bit-equal' if diff == 0.0 else f'max |diff| {diff:.3e}'}; "
        f"the replayed step 3 "
        f"{'bit-equal' if replay == 0.0 else f'differs by {replay:.3e}'}; "
        f"uninterrupted {[round(x, 6) for x in straight]}")
    return {"per_step": per_step, "remat": cfg.remat, "arch": TRAIN_ARCH}


def backward_ms(fn, inputs, reps=10):
    """ms of the backward of ``fn(*inputs)``, ``torch.autograd.grad`` of a
    kept output, by CUDA events around ``reps`` calls (each launches
    milliseconds of work, so the host's issue is a small part)."""
    out = fn(*inputs)
    grad = torch.randn_like(out)
    for _ in range(2):
        torch.autograd.grad(out, inputs, grad, retain_graph=True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        torch.autograd.grad(out, inputs, grad, retain_graph=True)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_train_remat(device):
    """internvl2-1b at full width under remat none | zero_buffer | full:
    host-clock ms per train step, tokens/s, device busy and idle share of a
    profiled step, peak device memory of a step; then the flash and FFN
    kernels' forward against the backward through their plain versions at
    the step's shapes. Returns each mode's (flash, FFN) launches per step,
    as counted over three steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    base = dataclasses.replace(registry.get(TRAIN_ARCH), attn_impl="kernel",
                               block_impl="fused")
    shape = InputShape("train_cli", TRAIN_SEQ, TRAIN_BATCH, "train")
    train = steps_mod.TrainSpec(peak_lr=3e-4, warmup_steps=1,
                                total_steps=100)
    data = SyntheticLMData(base, shape, seed=1)
    batches = [data.batch_at(i) for i in range(6)]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    card = card_line()
    rows = {}
    for mode in ("none", "zero_buffer", "full"):
        cfg = dataclasses.replace(base, remat=mode)
        step = steps_mod.build_train_step(cfg, train, shape, device)
        state = steps_mod.init_train_state(cfg, 0, train, device)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()     # params, m, v
        state, _ = step(state, batches[0])
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state, _ = step(state, batches[1])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        reset_lm_counts()
        t0 = time.perf_counter()
        for b in batches[2:5]:
            state, m = step(state, b)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 3 * 1e3
        total = lm_counts()
        counts = tuple(c // 3 for c in total)
        check(total == tuple(3 * c for c in counts)
              and counts == train_launches(cfg),
              f"remat {mode}: (flash, ffn) {counts} per step, expected "
              f"{train_launches(cfg)}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, m = step(state, batches[5])
            torch.cuda.synchronize()
        on_device = [e for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
        by_name = {}
        for e in on_device:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
        busy = sum(by_name.values()) if on_device else None
        check(np.isfinite(float(m["loss"])), f"remat {mode}: loss")
        rows[mode] = (host_ms, busy, peak, resident, counts)
        say(f"[train-remat] {TRAIN_ARCH} B{TRAIN_BATCH} T{TRAIN_SEQ} (+"
            f"{base.n_patches} patches) remat {mode}: "
            f"{busy_line(host_ms, busy, len(on_device))}; "
            f"{tokens / host_ms * 1e3:.1f} tokens/s; peak of a step "
            f"{peak / 2**30:.3f} GiB allocated ({(peak - resident) / 2**30:.3f}"
            f" GiB over the {resident / 2**30:.3f} GiB of params, m and v; "
            f"{after / 2**30:.3f} GiB between steps); launches (flash, ffn) "
            f"{counts} a step; {card}")
        for op, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            say(f"[train-remat]   {ms:.6f} ms  {op[:90]}")
        del state, step, m
        torch.cuda.empty_cache()
    order = [m for m, _ in sorted(rows.items(), key=lambda kv: -kv[1][2])]
    say(f"[train-remat] peak memory order: {' > '.join(order)} (predicted "
        f"none > zero_buffer > full)")

    # the prediction: backward through the plain versions vs the forward;
    # the forward is the kernel's launch alone (no grad), graph-captured
    gen = torch.Generator(device=device).manual_seed(3)
    t = TRAIN_BATCH * (TRAIN_SEQ + base.n_patches)
    d, f = base.d_model, base.d_ff
    x = torch.randn((t, d), generator=gen, device=device).to(torch.bfloat16)
    ws = [(torch.randn(s, generator=gen, device=device) * s[0] ** -0.5)
          .to(torch.bfloat16) for s in ((d, f), (d, f), (f, d))]
    ffn_in = [x.requires_grad_()] + [w.requires_grad_() for w in ws]
    ffn = lambda *a: ops.ffn(*a, act=base.act)
    with torch.no_grad():
        ffn_f = time_ms(lambda: ffn(*ffn_in))
    ffn_b = backward_ms(ffn, ffn_in)
    hp, hkv, hd = base.n_heads_padded, base.n_kv_heads, base.head_dim_
    qkv = [torch.randn((TRAIN_BATCH, t // TRAIN_BATCH, n, hd), generator=gen,
                       device=device).to(torch.bfloat16).requires_grad_()
           for n in (hp, hkv, hkv)]
    mha = lambda q, k, v: ops.mha(q, k, v, n_kv_heads=hkv)
    with torch.no_grad():
        fa_f = time_ms(lambda: mha(*qkv))
    fa_b = backward_ms(mha, qkv)
    say(f"[train-remat] backward through the plain version (CUDA events "
        f"around 10 calls) vs the kernel's forward (CUDA-graph replays) at "
        f"the step's shapes, bf16: FFN T{t} d{d} d_ff {f}: forward "
        f"{ffn_f:.6f} ms, backward {ffn_b:.6f} ms ({ffn_b / ffn_f:.2f}x); "
        f"flash B{TRAIN_BATCH} T{t // TRAIN_BATCH} H{hp}/{hkv} d{hd} causal: "
        f"forward {fa_f:.6f} ms, backward {fa_b:.6f} ms "
        f"({fa_b / fa_f:.2f}x); {card}")
    return {mode: row[4] for mode, row in rows.items()}


# --- phases 31-33: the multi-device runtime and the dry run ----------------

DIST_DRYRUN_CELLS = (("qwen2-72b", "train_4k", "single"),
                     ("llama4-scout-17b-a16e", "decode_32k", "multi"),
                     ("gemma2-9b", "prefill_32k", "single"),
                     ("gemma2-9b", "train_4k", "single"),
                     ("rwkv6-3b", "long_500k", "single"))
DIST_TRAIN_STEPS = 2
DIST_REPS = 10


@contextlib.contextmanager
def one_card_mesh():
    """An NCCL process group of one rank over this card and its (1, 1)
    ("data", "model") mesh; destroyed on exit."""
    init = Path(__file__).resolve().parent / "build" / f"pg-{os.getpid()}"
    init.parent.mkdir(parents=True, exist_ok=True)
    init.unlink(missing_ok=True)
    with mesh_lib.process_group("nccl", 1, 0, str(init)):
        yield mesh_lib.make_host_mesh(model=1, device_type="cuda")
    init.unlink(missing_ok=True)


class ThroughLocalMap:
    """Within the block, counts the kernel launches made inside
    ``local_map`` (the sharded model's local regions) apart from all."""

    def __enter__(self):
        self.saved, self.inside = actctx.local_map, [0, 0]

        def counted(fn, *a, **kw):
            def run(*args, **kwargs):
                before = lm_counts()
                try:   # a remat's recompute may stop early by raising
                    return fn(*args, **kwargs)
                finally:
                    after = lm_counts()
                    self.inside[0] += after[0] - before[0]
                    self.inside[1] += after[1] - before[1]
            return self.saved(run, *a, **kw)

        actctx.local_map = counted
        return self

    def __exit__(self, *exc):
        actctx.local_map = self.saved


def sync_ms(fn, reps=DIST_REPS):
    """Median host-clock ms of ``fn()`` to a synchronized card, after one
    warm call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def phase_sharded_serve(device):
    """Phase 31: gemma2-9b at full width and depth through
    ``build_prefill_step`` and ``build_decode_step`` on the one-card (1, 1)
    mesh: greedy tokens equal to the eager path's (``launch.serve``'s
    ``lm.prefill`` / ``lm.decode_step``), one flash per layer per prefill
    and one FFN per layer per prefill and decode step, every launch inside
    ``local_map``; prefill and decode-step host ms beside the eager
    path's."""
    cfg = gemma(attn_impl="kernel", block_impl="fused")
    n = cfg.n_layers
    cell = InputShape("serve", LM_PROMPT + LM_GEN, LM_BATCH, "prefill")
    params = lm.init_params(cfg, 0, device)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).to(device)
    max_len = LM_PROMPT + LM_GEN

    def eager_run():
        logits, cache = lm.prefill(params, cfg, prompts, max_len=max_len)
        toks = [greedy(logits, cfg)]
        for i in range(LM_GEN - 1):
            logits, cache = lm.decode_step(params, cfg, cache, toks[-1],
                                           LM_PROMPT + i)
            toks.append(greedy(logits, cfg))
        return torch.stack(toks, 1), cache

    with torch.no_grad():
        want, eager_cache = eager_run()
    with one_card_mesh() as mesh:
        sp = steps_mod.shard_params(params, mesh)
        pre = steps_mod.build_prefill_step(cfg, mesh, cell)
        dec = steps_mod.build_decode_step(cfg, mesh, cell)
        reset_lm_counts()
        with ThroughLocalMap() as through:
            logits, cache = pre(sp, {"tokens": prompts})
            torch.cuda.synchronize()
            pre_counts, pre_inside = lm_counts(), tuple(through.inside)
            toks = [greedy(logits.full_tensor(), cfg)]
            reset_lm_counts()
            through.inside[:] = [0, 0]
            for i in range(LM_GEN - 1):
                logits, cache = dec(sp, cache, toks[-1], LM_PROMPT + i)
                toks.append(greedy(logits.full_tensor(), cfg))
            torch.cuda.synchronize()
            dec_counts, dec_inside = lm_counts(), tuple(through.inside)
        got = torch.stack(toks, 1)
        check(torch.equal(got, want),
              "sharded serve tokens != the eager path's")
        check(pre_counts == (n, n) and pre_inside == pre_counts,
              f"sharded prefill launched (flash, ffn) {pre_counts}, "
              f"{pre_inside} inside local_map; expected ({n}, {n})")
        steps = LM_GEN - 1
        check(dec_counts == (0, n * steps) and dec_inside == dec_counts,
              f"sharded decode launched {dec_counts}, {dec_inside} inside "
              f"local_map; expected (0, {n * steps})")
        # host ms, the eager path and the mesh path in one run
        with torch.no_grad():
            e_pre = sync_ms(lambda: lm.prefill(params, cfg, prompts,
                                               max_len=max_len))
            e_dec = sync_ms(lambda: lm.decode_step(
                params, cfg, eager_cache, want[:, 0], LM_PROMPT))
        m_pre = sync_ms(lambda: pre(sp, {"tokens": prompts}))
        m_dec = sync_ms(lambda: dec(sp, cache, want[:, 0], LM_PROMPT))
        del sp, cache, logits
    del params, eager_cache
    torch.cuda.empty_cache()
    say(f"[dist-serve] gemma2-9b B{LM_BATCH} P{LM_PROMPT} +{LM_GEN} on the "
        f"one-card (1, 1) mesh (DTensor, NCCL): greedy tokens == eager "
        f"path's; launches (flash, ffn) prefill {pre_counts}, {steps} decode "
        f"steps {dec_counts}, all inside local_map")
    say(f"[dist-serve] host ms (median of {DIST_REPS}): prefill eager "
        f"{e_pre:.3f} / mesh {m_pre:.3f} ({m_pre - e_pre:+.3f}); decode "
        f"step eager {e_dec:.3f} / mesh {m_dec:.3f} ({m_dec - e_dec:+.3f}); "
        f"{card_line()}")
    return {"prefill_ms": [e_pre, m_pre], "decode_ms": [e_dec, m_dec]}


def phase_sharded_train(device):
    """Phase 32: internvl2-1b at full width through the mesh train step on
    the (1, 1) mesh, its state drawn shard by shard
    (``steps.init_sharded_train_state``), against the meshless step, same
    seed and batches: the
    losses within 1e-5 relative (bit-equal expected), 24 + 24 flash and FFN
    launches a step, all inside ``local_map``."""
    cfg = dataclasses.replace(registry.get(TRAIN_ARCH), attn_impl="kernel",
                              block_impl="fused")
    shape = InputShape("train_cli", TRAIN_SEQ, TRAIN_BATCH, "train")
    train = steps_mod.TrainSpec(peak_lr=3e-4, warmup_steps=1,
                                total_steps=DIST_TRAIN_STEPS)
    data = SyntheticLMData(cfg, shape, seed=0)
    step = steps_mod.build_train_step(cfg, train, shape, device)
    state = steps_mod.init_train_state(cfg, 0, train, device)
    plain = []
    for i in range(DIST_TRAIN_STEPS):
        state, m = step(state, data.batch_at(i))
        plain.append(float(m["loss"]))
    del state
    torch.cuda.empty_cache()
    want = train_launches(cfg)
    with one_card_mesh() as mesh:
        mstep = steps_mod.build_train_step(cfg, train, shape, mesh=mesh)
        # drawn shard by shard, as launch.train does on a mesh
        state = steps_mod.init_sharded_train_state(cfg, 0, train, mesh)
        meshed, counts = [], []
        for i in range(DIST_TRAIN_STEPS):
            reset_lm_counts()
            with ThroughLocalMap() as through:
                t0 = time.perf_counter()
                state, m = mstep(state, data.batch_at(i))
                loss = float(m["loss"].full_tensor())
                ms = (time.perf_counter() - t0) * 1e3
            counts.append((lm_counts(), tuple(through.inside), ms))
            meshed.append(loss)
        del state
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(meshed, plain))
    check(rel <= 1e-5, f"mesh losses {meshed} vs meshless {plain}")
    for c, inside, _ in counts:
        check(c == want and inside == c,
              f"mesh train step launched {c}, {inside} inside local_map; "
              f"expected {want}")
    say(f"[dist-train] {TRAIN_ARCH} B{TRAIN_BATCH} x ({cfg.n_patches} + "
        f"{TRAIN_SEQ}) on the (1, 1) mesh: losses {meshed} vs meshless "
        f"{plain}: {'bit-equal' if rel == 0.0 else f'max relative {rel:.3e}'}"
        f"; launches (flash, ffn) per step {counts[0][0]}, all inside "
        f"local_map; host ms per step {[round(c[2], 3) for c in counts]}")
    return rel


def phase_dryrun():
    """Phase 33: five full-size cells of the dry run, each under the fake
    process group of its mesh and on fake tensors, so the custom ops' fake
    impls and flop formulas stand in for the kernels."""
    out = Path(__file__).resolve().parent / "build" / "dryrun_smoke"
    shutil.rmtree(out, ignore_errors=True)
    for arch, shp, mesh_name in DIST_DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shp, mesh_name, out_dir=str(out),
                              verbose=False)
        check(rec["status"] == "ok",
              f"dry run {arch}/{shp}/{mesh_name}: {rec.get('error')}")
        mem = rec["memory"]
        check(rec["fake_device"] == "cuda" and mem["argument_bytes"] > 0
              and rec["hlo_flops"] > 0 and rec["fits"],
              f"dry run {arch}/{shp}: {rec['fake_device']}, "
              f"{mem['argument_bytes']} argument bytes + "
              f"~{mem['temp_bytes']} live, fits {rec['fits']}")
        t_max = max(rec["t_compute"], rec["t_memory"], rec["t_collective"])
        say(f"[dryrun] {arch}/{shp}/{mesh_name} ({rec['chips']} devices, "
            f"full depth, fake cuda): per device {mem['argument_bytes']:,} "
            f"argument bytes + ~{mem['temp_bytes']:,} live (estimate; "
            f"fits one card {rec['fits']}); "
            f"{rec['hlo_flops']:.6e} FLOPs, model/counted "
            f"{rec['useful_flops_frac']:.4f}; bound {rec['bottleneck']} "
            f"{t_max:.6f} s on {rec['hardware']} (links {rec['links']}); "
            f"{time.perf_counter() - t0:.2f} s")
    shutil.rmtree(out, ignore_errors=True)


def phases_dist(device):
    """Phases 31-33, the multi-device runtime on one card and the dry run:
    their seconds."""
    t0 = time.perf_counter()
    phase_sharded_serve(device)
    phase_sharded_train(device)
    phase_dryrun()
    took = time.perf_counter() - t0
    say(f"[dist] phases 31-33: {took:.2f} s")
    return took


# --- phase 34: the dry run's live estimate against the card's allocator ----

MEMORY_ARCHS = ("rwkv6-3b", "gemma2-9b")
MEMORY_UNITS = 2
MEMORY_SEQ = 4096
MEMORY_DATA_SHARDS = 16           # the (16, 16) mesh's batch shards
MEMORY_FLOOR = 0.8                # estimate / card below this: optimistic
# rows below one train_4k microbatch's per-device rows, and why
MEMORY_ROW_CUT = {
    "gemma2-9b": (2, "the meshless loss holds the whole 256,000-word vocab: "
                     "four (B T, V) f32 tensors at its peak, 15.6 GiB each "
                     "at B 4, which with the 29.4 GiB of f32 params, m and "
                     "v do not fit 80 GB (the (16, 16) mesh splits the "
                     "vocab 16 ways)"),
}


def memory_check_shape(name):
    """(``name``'s config at ``MEMORY_UNITS`` pattern units, the step's
    InputShape, the microbatch's rows on the mesh, the cut's reason or
    None)."""
    cfg = registry.get(name)
    cfg = dataclasses.replace(cfg, n_layers=MEMORY_UNITS * len(cfg.pattern),
                              attn_impl="kernel", block_impl="fused")
    train4k = SHAPES_BY_NAME["train_4k"]
    rows = (train4k.global_batch // MEMORY_DATA_SHARDS
            // cfg.microbatch_for("train_4k"))
    cut_rows, why = MEMORY_ROW_CUT.get(name, (rows, None))
    shape = InputShape("memory_check", MEMORY_SEQ, min(rows, cut_rows),
                       "train")
    return cfg, shape, rows, why


def estimated_step(cfg, shape, train, device_type):
    """The dry run's count of one meshless train step on fake tensors of
    ``device_type``: (its ``OpCostMode``, the state's and batch's bytes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.roofline.op_cost import OpCostMode
    dev = torch.device(device_type)
    with FakeTensorMode():
        params = dryrun._fake_leaves(lm.abstract_params(cfg, torch.float32),
                                     dev)
        state = steps_mod.train_state(params, train)
        batch = steps_mod.abstract_batch(cfg, shape, dev)
        step = steps_mod.build_train_step(cfg, train, shape, dev)
        args = dryrun._local_bytes(state) + dryrun._local_bytes(batch)
        with OpCostMode() as mode:
            step(state, batch)
    return mode, args


def phase_memory_check(device):
    """Phase 34: one real train step of each of ``MEMORY_ARCHS`` at full
    width and ``MEMORY_UNITS`` pattern units, at a train_4k microbatch's
    rows per device x 4096 tokens (cut where ``MEMORY_ROW_CUT`` says), on
    the meshless one-card path through the kernels: the card's peak
    allocated bytes over what the step's arguments hold
    (``max_memory_allocated`` after ``reset_peak_memory_stats``, less
    ``memory_allocated`` before the step), against ``OpCostMode``'s
    ``peak_live_bytes`` for the same step on fake tensors. Fails where the
    estimate is below ``MEMORY_FLOOR`` of the card's reading."""
    t0 = time.perf_counter()
    train = steps_mod.TrainSpec(peak_lr=3e-4, warmup_steps=1,
                                total_steps=10)
    card = card_line()
    rows_out = {}
    for name in MEMORY_ARCHS:
        cfg, shape, rows, why = memory_check_shape(name)
        t1 = time.perf_counter()
        mode, arg_bytes = estimated_step(cfg, shape, train,
                                         dryrun.fake_device_type())
        est_s = time.perf_counter() - t1
        est = mode.peak_live_bytes
        top = sorted(mode.peak_live_by.items(), key=lambda kv: -kv[1][0])[:3]
        state = steps_mod.init_train_state(cfg, 0, train, device)
        gen = torch.Generator(device=device).manual_seed(34)
        batch = {k: torch.randint(0, cfg.vocab, (shape.global_batch,
                                                 shape.seq_len),
                                  generator=gen, device=device,
                                  dtype=torch.int32)
                 for k in ("tokens", "labels")}
        step = steps_mod.build_train_step(cfg, train, shape, device)
        state, m = step(state, batch)             # warm: allocator, caches
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_lm_counts()
        t1 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t1) * 1e3
        counts = lm_counts()
        used = torch.cuda.max_memory_allocated() - held
        check(np.isfinite(float(m["loss"])), f"{name}: loss {m['loss']}")
        check(counts == train_launches(cfg),
              f"{name}: the step launched (flash, ffn) {counts}, expected "
              f"{train_launches(cfg)}")
        ratio = est / used
        rows_out[name] = (est, used, ratio)
        say(f"[memory] {name} at {cfg.n_layers} layers ({MEMORY_UNITS} "
            f"units), full width, B {shape.global_batch} x T "
            f"{shape.seq_len} (a train_4k microbatch is {rows} rows a "
            f"device" + (f"; cut: {why}" if why else "") + f"), meshless, "
            f"kernels (flash, ffn) {counts}: card peak over arguments "
            f"{used:,} B ({used / 2**30:.3f} GiB; arguments {held:,} B held, "
            f"{arg_bytes:,} B counted); estimate {est:,} B "
            f"({est / 2**30:.3f} GiB, {est_s:.1f} s on fake "
            f"{dryrun.fake_device_type()} tensors); estimate / card "
            f"{ratio:.4f}; step {step_ms:.3f} ms; {card}")
        say(f"[memory]   the estimate's peak: " + "; ".join(
            f"{b / 2**30:.3f} GiB x{n} {k}" for k, (b, n) in top))
        del state, step, m, batch
        torch.cuda.empty_cache()
    for name, (est, used, ratio) in rows_out.items():
        check(ratio >= MEMORY_FLOOR,
              f"{name}: the live estimate {est:,} B is {ratio:.4f} of the "
              f"card's {used:,} B, below {MEMORY_FLOOR}: fits is optimistic")
    say(f"[memory] phase 34: {time.perf_counter() - t0:.2f} s")
    return rows_out


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

    serve_s, serve_launches, spot_split = phase_cfu_serving(net_cpu, device)
    added_s = (serve_s + phase_cfu_spot_times(net_cpu, device)
               + phase_cfu_reliability_doctor(device))
    say(f"[cfu-serve] phases 17-19: {added_s:.2f} s")
    for e in entries:
        if e["source"] == SOURCE:
            e["launches_per_spot_check"] = dict(
                spot_split, per_check=sum(spot_split.values()),
                serving_runs=serve_launches)

    t0 = time.perf_counter()
    phase_dense_kernel_vs_plain(device)
    runs = {name: phase_arch_serve(name, device) for name in DENSE_DECODERS}
    runs[ENCODER] = phase_encoder_forward(device)
    entries += phase_dense_kernel_times(device, runs)
    dense_summary(runs)
    say(f"[dense] phases 20-24: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    family = {name: phase_arch_serve(name, device, "family")
              for name in FAMILY_ARCHS}
    entries += phase_dense_kernel_times(device, family, FAMILY_ARCHS, 61)
    dense_summary(family, "family-summary")
    say(f"[family] phases 25-27: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    phase_train_grads(device)
    per_train_step = phase_train_entry(device)
    by_remat = phase_train_remat(device)
    for e in entries:
        if e["source"] in (FLASH_SOURCE, FFN_SOURCE):
            i = 0 if e["source"] == FLASH_SOURCE else 1
            # measured: phase 29's launches over its steps; the forward's
            # is phase 30's step under remat none, whose backward launches
            # nothing
            e["launches_per_train_step"] = {
                "arch": per_train_step["arch"],
                "remat": per_train_step["remat"],
                "forward": by_remat["none"][i],
                "per_step": per_train_step["per_step"][i],
                "per_step_by_remat": {m: c[i] for m, c in by_remat.items()}}
    say(f"[train] phases 28-30: {time.perf_counter() - t0:.2f} s")
    phases_dist(device)
    phase_memory_check(device)
    say(card_line())
    say("kernels " + json.dumps(entries))
    say(json.dumps({"kernels": entries}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
