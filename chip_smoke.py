#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path, int8 MobileNetV2-VWW inference through the
hand-written fused DSC kernel, and fails (non-zero exit, no result line) on
any error. Phases:

1. the card's name and power limit (nvidia-smi); no CUDA device -> fail;
2. build every kernel from src/repro_torch/kernels/csrc (one nvcc each, all
   at once) and print the build time and the ptxas register/smem lines;
3. kernel vs plain version: ``fused_dsc_cuda`` must equal
   ``ref.fused_dsc_ref`` on the card and on the CPU (``torch.equal``) for the
   seven blocks of the 80x80 network at batch 64, the eight ragged shapes of
   tests/test_kernels.py and one block with a non-zero float expansion bias;
4. end to end: the seed-0 80x80 network on 256 seeded images through
   ``forward_batch(use_kernel=True)`` on the card; its int8 logits must equal
   the plain v0 forward on the CPU, and the launch count must grow by 7;
5. serve: ``launch.serve.main(["--mobilenet", "--batch", "256"])``;
6. per block at batch 256: kernel time (CUDA events, warm L2 as in the
   forward, where each block's input was just written by the previous one),
   plain-version time, and the bound max(ops / 1,979 TOP/s, bytes / 3.35 TB/s);
7. where a forward's time goes at batch 1 and 256: host-clock latency and
   the device time torch.profiler records.

The last stdout line is {"ok": true, "device": {...}}; the line before it is
the {"kernels": [...]} record.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import dsc  # noqa: E402
from repro_torch.core.dsc import DSCBlockSpec as S  # noqa: E402
from repro_torch.core.fusion import Schedule  # noqa: E402
from repro_torch.kernels import build, fused_dsc, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
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


def network_block_cases(net_cpu, batch: int, rng):
    """(name, x, block params) for the seven blocks at their 80x80-network
    input sizes, with seeded random int8 inputs."""
    hw, cases = 40, []   # 40: the stem output of an 80x80 image
    for (name, *_), qp in zip(mnv2.PAPER_BLOCKS, net_cpu.blocks):
        x = rng.integers(-128, 128, (batch, hw, hw, qp.spec.cin), np.int8)
        cases.append((name, torch.from_numpy(x), qp))
        hw = qp.spec.out_hw(hw, hw)[0]
    return cases


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
    check("fused_dsc" in built, "fused_dsc was not built")


def run_kernel_vs_plain(name, x_cpu, qp_cpu, device, tile_rows=4) -> None:
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


def phase_kernel_vs_plain(net_cpu, device, batch=64):
    rng = np.random.default_rng(11)
    n = 0
    for name, x, qp in network_block_cases(net_cpu, batch, rng):
        run_kernel_vs_plain(name, x, qp, device)
        n += 1
    for name, x, qp, tile_rows in ragged_block_cases(rng):
        run_kernel_vs_plain(name, x, qp, device, tile_rows)
        n += 1
    say(f"[kernel] fused_dsc == fused_dsc_ref (card and CPU) on {n} shapes")


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
            "name": f"fused_dsc[{name}]", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": per_block, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "ops": ops, "bytes": nbytes,
            "shape": list(x.shape), "cmid": qp.spec.cmid,
            "cout": qp.spec.cout, "stride": qp.spec.stride})
        say(f"[time] {name:>4} x{tuple(x.shape)}: kernel {ms:.6f} ms, plain "
            f"{plain_ms:.6f} ms, bound {bound_ms:.6f} ms ({bound_by}), "
            f"{bound_ms / ms:.2%} of bound")
    total = sum(e["ms"] for e in entries)
    say(f"[time] seven blocks at batch {batch}: kernel {total:.6f} ms, "
        f"bound {sum(e['bound_ms'] for e in entries):.6f} ms")
    return entries


def phase_profile(net_cpu, device, batches=(1, 256), reps=5):
    """Where a forward's time goes: the host-clock latency of the eager
    forward (unprofiled), and the device time its kernels and copies take
    (torch.profiler, CUPTI). Their difference is the device's idle time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    net = net_cpu.to(device)
    rng = np.random.default_rng(2)
    for batch in batches:
        imgs = torch.from_numpy(rng.standard_normal(
            (batch, 80, 80, 3)).astype(np.float32)).to(device)
        fwd = lambda: mnv2.forward_batch(imgs, net, use_kernel=True)
        for _ in range(3):
            fwd()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fwd()
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / reps * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fwd()
            torch.cuda.synchronize()
        on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not on_device:
            say(f"[profile] batch {batch}: eager forward {eager_ms:.6f} ms; "
                "the profiler recorded no device time: busy share not "
                "measured")
            continue
        by_name = {}
        for e in on_device:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
        busy_ms = sum(by_name.values()) / 1e3 / reps
        say(f"[profile] batch {batch}: eager forward {eager_ms:.6f} ms "
            f"(host clock); device busy {busy_ms:.6f} ms per forward "
            f"({busy_ms / eager_ms:.2%}), idle share "
            f"{1 - busy_ms / eager_ms:.2%}; {len(on_device) // reps} device "
            "activities per forward")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            say(f"[profile]   {us / 1e3 / reps:.6f} ms  {name[:90]}")


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
    launches = phase_end_to_end(net_cpu, device)
    phase_serve(net_cpu)
    entries = phase_kernel_times(net_cpu, device, launches)
    phase_profile(net_cpu, device)
    say("kernels " + json.dumps(entries))
    say(json.dumps({"kernels": entries}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
