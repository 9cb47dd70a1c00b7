#!/usr/bin/env python3
"""Probe of the fused DSC kernel on one card.

    python3 probes/dsc_kernel.py check
    python3 probes/dsc_kernel.py time [--parent DIR]
    python3 probes/dsc_kernel.py ablate [VARIANT ...] [--sass FILE]

``check`` builds ``csrc/fused_dsc.cu``, prints its ptxas lines and the
count of IMMA instructions in its SASS, and holds the kernel to
``ref.fused_dsc_ref`` (``torch.equal``, card and CPU) on the seven blocks of
the 80x80 MobileNetV2-VWW network at batch 1, 64 and 256 (the plan's
tiles, with the built launcher's plan held to ``fused_dsc.plan``), and on
chip_smoke.py's ragged shapes and non-zero ``b_exp`` block with their tile
rows and the plan's.

``time`` prints each block's CUDA-graph time at batch 256 and 1. With
``--parent DIR`` (a checkout of another tree) it also times that tree's
kernel on the same inputs in the same process, in turns: parent, change,
change, parent.

``ablate`` builds variants of ``csrc/fused_dsc.cu`` made by editing its
text in a scratch directory (``build/probe``): without one of its three
phases (the output is then wrong and not checked), or with other
constants or tile heights. It times each beside the tree's kernel, in
turns, at batch 256 and 1; with ``--sass FILE`` it writes the tree
kernel's SASS there. The tree's sources are not changed.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build, fused_dsc, ref  # noqa: E402
from repro_torch.models import mobilenetv2 as mnv2  # noqa: E402


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def run(name, x_cpu, qp, dev, tile_rows):
    tensors, st = cs.block_args(qp)
    x = x_cpu.to(dev)
    ts = [t.to(dev) for t in tensors]
    got = fused_dsc.fused_dsc_cuda(x, *ts, tile_rows=tile_rows, **st)
    want = ref.fused_dsc_ref(x, *ts, **st)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        diff = (got.int() - want.int()).abs()
        raise SystemExit(f"{name}: kernel != plain, max |diff| "
                         f"{int(diff.max())}, {int((diff > 0).sum())} of "
                         f"{diff.numel()} differ, first at "
                         f"{diff.nonzero()[:8].tolist()}")
    assert torch.equal(got.cpu(), ref.fused_dsc_ref(x_cpu, *tensors, **st))


def check(dev):
    built = build.load("fused_dsc")
    print(f"[build] {built.path.name} nvcc {built.seconds:.2f} s")
    for line in built.ptxas:
        print(f"[build]   {line}")
    print(f"[sass] IMMA per kernel: {cs.sass_counts(built.path, 'IMMA')}")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    net = mnv2.init_and_quantize(0, img_hw=80, device="cpu")
    rng = np.random.default_rng(11)
    n = 0
    for batch in (1, 64, 256):
        for name, x, qp in cs.network_block_cases(net, batch, rng):
            sp = qp.spec
            b, h, w, _ = x.shape
            pl = fused_dsc.plan(b, h, w, sp.cin, sp.cmid, sp.cout, sp.stride,
                                None, n_sm)
            assert fused_dsc.kernel_plan(b, h, w, sp.cin, sp.cmid, sp.cout,
                                         sp.stride, None, n_sm) \
                == pl.as_tuple(), (name, batch)
            occ = fused_dsc.occupancy(sp.stride, sp.cin, pl.smem_bytes)
            run(f"{name}@B{batch}", x, qp, dev, None)
            print(f"[check] {name} B{batch}: tile_rows {pl.tile_rows}, units "
                  f"{pl.units}, grid {pl.grid}, smem {pl.smem_bytes}, plan "
                  f"{pl.blocks_per_sm}/SM, card {occ}/SM: equal")
            n += 1
    for name, x, qp, tile_rows in cs.ragged_block_cases(rng):
        for t in (tile_rows, None):
            run(f"{name} t{t}", x, qp, dev, t)
            n += 1
    print(f"[check] fused_dsc == fused_dsc_ref (card and CPU) on {n} cases")


def load_tree(path: Path):
    """The fused_dsc module of another checkout, under another name, with
    that checkout's build module (so its own csrc and build directory)."""
    mods = {}
    for name in ("build", "fused_dsc"):
        spec = importlib.util.spec_from_file_location(
            f"parent_{name}", path / f"src/repro_torch/kernels/{name}.py")
        mods[name] = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mods[name]
        spec.loader.exec_module(mods[name])
    mods["fused_dsc"].build = mods["build"]
    return mods["fused_dsc"]


def time_blocks(dev, parent_dir):
    print(card())
    parent = load_tree(Path(parent_dir)) if parent_dir else None
    net = mnv2.init_and_quantize(0, img_hw=80, device="cpu")
    rng = np.random.default_rng(12)
    for batch in (256, 1):
        totals = {}
        for name, x_cpu, qp in cs.network_block_cases(net, batch, rng):
            tensors, st = cs.block_args(qp)
            x = x_cpu.to(dev)
            ts = [t.to(dev) for t in tensors]
            kern = lambda: fused_dsc.fused_dsc_cuda(x, *ts, **st)
            want = ref.fused_dsc_ref(x, *ts, **st)
            assert torch.equal(kern(), want)
            order = [("change", kern), ("change", kern)]
            if parent is not None:
                old = lambda: parent.fused_dsc_cuda(x, *ts, **st)
                assert torch.equal(old(), want)
                order = [("parent", old)] + order + [("parent", old)]
            row = {}
            for who, fn in order:
                row.setdefault(who, []).append(cs.time_ms(fn))
            print(f"[time] B{batch} {name}: " + ", ".join(
                f"{k} {' / '.join(f'{v:.6f}' for v in vs)} ms"
                for k, vs in row.items()))
            for k, vs in row.items():
                totals[k] = totals.get(k, 0.0) + min(vs)
        print(f"[time] B{batch} seven blocks (best of each): " + ", ".join(
            f"{k} {v:.6f} ms" for k, v in totals.items()))


def _cut(src, start, end):
    i, j = src.index(start), src.index(end)
    return src[:i] + src[j:]


# name -> (edit of the source text, Python constants to set alongside; the
# key "_tile" maps the plan's tile rows and the output height to another)
VARIANTS = {
    "no-expansion": (lambda s: _cut(
        s, "    // ---- Expansion:", "    // ---- Depthwise:"), {}),
    "no-depthwise": (lambda s: _cut(
        s, "    // ---- Depthwise:", "    // ---- Projection:"), {}),
    "no-projection": (lambda s: _cut(
        s, "    // ---- Projection:", "    // The next iteration"), {}),
    "bps3": (lambda s: s.replace("kMaxBlocksPerSm = 2;", "kMaxBlocksPerSm = 3;"),
             {"MAX_BLOCKS_PER_SM": 3}),
    "run3": (lambda s: s.replace("kRun = 5;", "kRun = 3;"), {"RUN": 3}),
    "taller": (lambda s: s, {"_tile": lambda t, h2: min(2 * t, h2)}),
    "shorter": (lambda s: s, {"_tile": lambda t, h2: max(1, t // 2)}),
}


def build_variant(name, text):
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / f"fused_dsc_{name}.cu"
    src.write_text(text)
    lib = out / f"fused_dsc_{name}.so"
    r = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I",
                        str(build.CSRC), "-o", str(lib), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    regs = sorted({ln.strip() for ln in (r.stdout + r.stderr).splitlines()
                   if "registers" in ln or "spill" in ln})
    print(f"[ablate] {name}: " + " | ".join(regs))
    cdll = ctypes.CDLL(str(lib))
    cdll.fused_dsc_launch.argtypes = fused_dsc._ARGTYPES
    cdll.fused_dsc_launch.restype = ctypes.c_int
    cdll.fused_dsc_error_string.argtypes = [ctypes.c_int]
    cdll.fused_dsc_error_string.restype = ctypes.c_char_p
    return cdll


def ablate(dev, names, sass_file):
    print(card())
    text = (build.CSRC / "fused_dsc.cu").read_text()
    tree = fused_dsc._lib()
    libs = {"tree": (tree, {})}
    for name in names:
        edit, consts = VARIANTS[name]
        libs[name] = (tree if edit(text) == text else
                      build_variant(name, edit(text)), consts)
    defaults = {k: getattr(fused_dsc, k) for k in ("MAX_BLOCKS_PER_SM", "RUN")}
    tool = shutil.which("cuobjdump", path=build.CUDA_BIN)
    if sass_file and tool is not None:
        sass = Path(sass_file)
        sass.parent.mkdir(parents=True, exist_ok=True)
        sass.write_text(subprocess.run(
            [tool, "-sass", str(build.load("fused_dsc").path)],
            capture_output=True, text=True).stdout)
        print(f"[ablate] the tree kernel's SASS: {sass}")
    net = mnv2.init_and_quantize(0, img_hw=80, device="cpu")
    rng = np.random.default_rng(12)
    for batch in (256, 1):
        totals = {}
        for bname, x_cpu, qp in cs.network_block_cases(net, batch, rng):
            tensors, st = cs.block_args(qp)
            x = x_cpu.to(dev)
            ts = [t.to(dev) for t in tensors]
            want = ref.fused_dsc_ref(x, *ts, **st)
            sp, h = qp.spec, x.shape[1]
            row = {}
            for turn in range(2):   # in turns: forwards, then backwards
                order = list(libs.items())
                for name, (lib, consts) in (order if turn == 0
                                            else order[::-1]):
                    tile = None
                    for k, v in {**defaults, **consts}.items():
                        if k == "_tile":
                            t = fused_dsc.plan(batch, h, h, sp.cin, sp.cmid,
                                               sp.cout, sp.stride).tile_rows
                            tile = v(t, -(-h // sp.stride))
                        else:
                            setattr(fused_dsc, k, v)
                    fused_dsc._lib = lambda lib=lib: lib
                    kern = lambda: fused_dsc.fused_dsc_cuda(
                        x, *ts, tile_rows=tile, **st)
                    if not name.startswith("no-"):
                        assert torch.equal(kern(), want), (name, bname)
                    row.setdefault(name, []).append(cs.time_ms(kern))
            for k, v in defaults.items():
                setattr(fused_dsc, k, v)
            fused_dsc._lib = lambda: tree
            print(f"[ablate] B{batch} {bname}: " + ", ".join(
                f"{k} {min(v):.6f}" for k, v in row.items()))
            for k, v in row.items():
                totals[k] = totals.get(k, 0.0) + min(v)
        print(f"[ablate] B{batch} seven blocks: " + ", ".join(
            f"{k} {v:.6f} ms" for k, v in totals.items()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["check", "time", "ablate"])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--parent", default=None)
    ap.add_argument("--sass", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.mode == "check":
        check(dev)
    elif args.mode == "ablate":
        ablate(dev, args.variants, args.sass)
    else:
        time_blocks(dev, args.parent)


if __name__ == "__main__":
    main()
