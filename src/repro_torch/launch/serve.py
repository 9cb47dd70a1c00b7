"""Serving launcher: batched prefill + greedy decode loop (LM), or batched
int8 image classification (MobileNetV2-VWW, the paper's own deployment), on
the card through the hand-written kernels.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
        --batch 4 --prompt-len 512 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-72b \
        --layers 32 --batch 4 --prompt-len 512 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama4-scout-17b-a16e --layers 12 --batch 4 --prompt-len 512 \
        --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --mobilenet --batch 256

``--arch`` runs the reference launcher's LM loop with seeded random
weights: one prefill of ``--batch`` prompts of ``--prompt-len`` tokens, then
``--gen - 1`` decode steps, each token the argmax of the last logits.
Every ported arch but the encoder-only hubert-xlarge, which exits as the
reference launcher does. For the vision stub (internvl2-1b) the prompts
follow ``n_patches`` patch embeddings drawn from ``--seed`` (scale 0.02),
and the KV cache and decode positions count them. The MoE, recurrent
(RG-LRU) and rwkv layer kinds carry their own state in the cache. ``--layers``
cuts the depth (a model too large for one card at full depth, such as
qwen2-72b's 145 GB or llama4-scout's 216.5 GB in bf16); the width stays the
config's.
``--attn-impl`` and ``--block-impl`` set the config's attention and FFN
disciplines; their defaults, ``kernel`` and ``fused``, run the flash-
attention and fused-FFN kernels on a card (``--attn-impl fused
--block-impl reference`` is the reference launcher's own setting). On a
card the weights are stored in the config's dtype (bf16), norm scales and
the leaves the reference uses at their f32 masters (``layers.F32_LEAVES``)
in f32.

``--mobilenet`` sweeps batch sizes 1, 2, 4, ... up to ``--batch``; each size
runs one warm-up forward, then one timed forward between two
``torch.cuda.synchronize()`` calls.

On ``--device cpu`` every kernel call runs its plain PyTorch version.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.configs.vww import VWW
from repro_torch.models import lm
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


def serve_lm(args) -> np.ndarray:
    """Batched prefill, then a greedy decode loop; returns the generated
    tokens, (batch, gen)."""
    dev = resolve_device(args.device)
    cfg = (registry.get_smoke(args.arch) if args.smoke
           else registry.get(args.arch))
    if args.arch in registry.ENCODER_ONLY:
        raise SystemExit("encoder-only arch has no decode path")
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl,
                              block_impl=args.block_impl)
    if args.layers is not None and args.layers != cfg.n_layers:
        print(f"[serve] depth cut to {args.layers} of {cfg.n_layers} layers "
              f"(--layers); width as the config's")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    print(f"[serve] arch={cfg.name} params={cfg.param_count():,} "
          f"attn={cfg.attn_impl} ffn={cfg.block_impl} on {device_label(dev)}")
    params = lm.init_params(cfg, args.seed, dev)
    off = cfg.n_patches if cfg.frontend == "vision" else 0
    max_len = off + args.prompt_len + args.gen
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))).to(dev)
    patches = (torch.from_numpy(rng.standard_normal(
        (args.batch, cfg.n_patches, cfg.d_model)).astype(np.float32)).to(dev)
        * 0.02 if cfg.frontend == "vision" else None)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = lm.prefill(params, cfg, prompts, patches=patches,
                               max_len=max_len)
    tok = logits[:, :cfg.vocab].argmax(dim=-1)
    out_tokens = [tok]
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        logits, cache = lm.decode_step(params, cfg, cache, tok,
                                       off + args.prompt_len + i)
        tok = logits[:, :cfg.vocab].argmax(dim=-1)
        out_tokens.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    gen = torch.stack(out_tokens, dim=1).cpu().numpy()
    steps = args.gen - 1
    rate = (f"{args.batch * steps / t_decode:.1f} tok/s"
            if steps and t_decode > 0 else "no decode steps")
    prefix = f" after {off} patches" if off else ""
    print(f"[serve] prefill {args.batch}x{args.prompt_len} tok{prefix} in "
          f"{t_prefill * 1e3:.3f} ms; {steps} decode steps of batch "
          f"{args.batch} in {t_decode * 1e3:.3f} ms ({rate})")
    print(f"[serve] sample continuation (seq 0): {gen[0][:12].tolist()}")
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=registry.ARCH_NAMES + registry.PORT_ONLY,
                    help="LM prefill + greedy decode with seeded weights")
    ap.add_argument("--mobilenet", action="store_true",
                    help="batch-size throughput sweep of the int8 "
                         "MobileNetV2-VWW network through the fused DSC "
                         "kernel")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch's depth to this many layers (its "
                         "width stays); default: the config's")
    ap.add_argument("--attn-impl", choices=("reference", "fused", "kernel"),
                    default="kernel")
    ap.add_argument("--block-impl", choices=("reference", "fused"),
                    default="fused")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.batch < 1:
        ap.error("--batch must be >= 1")
    if args.mobilenet:
        return serve_mobilenet(args)
    if not args.arch:
        ap.error("--arch or --mobilenet is required")
    if args.prompt_len < 1 or args.gen < 1:
        ap.error("--prompt-len and --gen must be >= 1")
    if args.layers is not None and args.layers < 1:
        ap.error("--layers must be >= 1")
    return serve_lm(args)


if __name__ == "__main__":
    main()
