"""Serving launcher: batched int8 image classification (MobileNetV2-VWW,
the paper's own deployment) on the card, through the fused DSC kernel.

    PYTHONPATH=src python -m repro_torch.launch.serve --mobilenet --batch 256
    PYTHONPATH=src python -m repro_torch.launch.serve --mobilenet --batch 2 \
        --device cpu

``--mobilenet`` sweeps batch sizes 1, 2, 4, ... up to ``--batch``; each size
runs one warm-up forward, then one timed forward between two
``torch.cuda.synchronize()`` calls. On ``--device cpu`` the blocks run the
kernel's plain PyTorch version. The LM path (``serve_lm``) is not ported
yet (ROADMAP.md Queue 1, LM path).
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.vww import VWW
from repro_torch.models import mobilenetv2 as mnv2


def device_label(dev: torch.device) -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    if dev.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(dev)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        limit = "power limit not read"
    return f"{name}, {limit.strip()}"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_mobilenet(args) -> np.ndarray:
    """Batch-size throughput sweep of the int8 network through the kernel."""
    dev = resolve_device(args.device)
    net = mnv2.init_and_quantize(args.seed, img_hw=VWW.img_hw, device=dev)
    rng = np.random.default_rng(args.seed)
    imgs = torch.from_numpy(rng.standard_normal(
        (args.batch, VWW.img_hw, VWW.img_hw, VWW.img_ch)).astype(np.float32))
    imgs = imgs.to(dev)
    label = device_label(dev)
    path = "fused DSC kernel" if dev.type == "cuda" else "kernel's plain version"
    sizes = sorted({1 << i for i in range(args.batch.bit_length())
                    if 1 << i <= args.batch} | {args.batch})
    preds = None
    for b in sizes:
        batch = imgs[:b]
        mnv2.forward_batch(batch, net, use_kernel=True)    # warm this shape
        _sync(dev)
        t0 = time.perf_counter()
        logits = mnv2.forward_batch(batch, net, use_kernel=True)
        _sync(dev)
        dt = time.perf_counter() - t0
        preds = logits.argmax(dim=-1).cpu().numpy()
        print(f"[serve] MobileNetV2 int8 ({path}) on {label}: batch "
              f"{b} in {dt * 1e3:.3f} ms ({b / dt:.1f} img/s)")
    print(f"[serve] preds (batch {sizes[-1]}): {preds.tolist()}")
    return preds


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mobilenet", action="store_true",
                    help="batch-size throughput sweep of the int8 "
                         "MobileNetV2-VWW network through the fused DSC "
                         "kernel")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if not args.mobilenet:
        ap.error("--mobilenet is required: the LM path is not ported yet "
                 "(ROADMAP.md Queue 1, LM path)")
    if args.batch < 1:
        ap.error("--batch must be >= 1")
    return serve_mobilenet(args)


if __name__ == "__main__":
    main()
