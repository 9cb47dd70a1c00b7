"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-1b \\
        --smoke --device cpu --steps 4 --batch 2 --seq 16 \\
        --ckpt-dir build/ckpt --ckpt-period 2 --inject-failure-at 3

``--smoke`` selects the reduced config, which trains on the CPU; on a card
(``--device cuda``, the default) the full configs train with f32 AdamW
state, and ``--attn-impl kernel --block-impl fused`` (the defaults) run the
hand-written flash-attention and fused-FFN kernels in the train step's
forward. The loop is the fault-tolerant driver: deterministic step-indexed
data, periodic async checkpoints, EWMA straggler watchdog,
restart-on-failure. Remat follows the config's ``remat``, as in the
reference.

Under ``torchrun`` (``WORLD_SIZE`` set) each rank takes its own card, the
group starts from the launcher's environment, and the step runs on a host
mesh (``launch/mesh.make_host_mesh``), as the reference's does: ("data",
"model") over every rank, ``--mesh-model`` ranks on the model axis. The
state is drawn shard by shard (``steps.init_sharded_train_state``), so no
rank ever holds the whole of it. A single process (the default) runs the
one-device step: on a (1, 1) mesh every placement is ``Replicate``, and
the DTensor dispatch would cost host time and shard nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.configs.base import InputShape
from repro_torch.data import SyntheticLMData
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime import steps as steps_mod
from repro_torch.runtime.fault import FailureInjector, TrainDriver, Watchdog


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=registry.ARCH_NAMES, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-period", type=int, default=50)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--inject-failure-at", type=int, default=-1,
                    help="simulate a preemption at this step (demo)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--attn-impl", choices=("reference", "fused", "kernel"),
                    default="kernel")
    ap.add_argument("--block-impl", choices=("reference", "fused"),
                    default="fused")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="ranks on the mesh's model axis")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    with _process_group(device):
        return _run(args, device)


@contextlib.contextmanager
def _process_group(device):
    """Under torchrun, the launcher's group, each rank on its own card,
    destroyed on exit; a single process runs in none."""
    if "WORLD_SIZE" not in os.environ:
        yield
        return
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    try:
        yield
    finally:
        dist.destroy_process_group()


def _run(args, device):

    cfg = (registry.get_smoke(args.arch) if args.smoke
           else registry.get(args.arch))
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl,
                              block_impl=args.block_impl)
    shape = InputShape("train_cli", args.seq, args.batch, "train")
    train = steps_mod.TrainSpec(
        peak_lr=args.lr, warmup_steps=args.warmup,
        total_steps=max(args.steps, 1),
        grad_compression=args.grad_compression)

    mesh = None
    if dist.is_initialized():
        mesh = make_host_mesh(model=args.mesh_model, device_type=device.type)
    elif args.mesh_model > 1:
        raise SystemExit("--mesh-model above 1 needs ranks: run under "
                         "torchrun")
    layout = (dict(zip(mesh.mesh_dim_names, mesh.shape)) if mesh is not None
              else "none")
    print(f"[train] arch={cfg.name} params={cfg.param_count():,} "
          f"device={device} mesh={layout} "
          f"batch={args.batch} seq={args.seq} "
          f"dtype={cfg.dtype} remat={cfg.remat} attn={cfg.attn_impl} "
          f"block={cfg.block_impl}")
    step_fn = steps_mod.build_train_step(cfg, train, shape, device,
                                         mesh=mesh)
    data = SyntheticLMData(cfg, shape, seed=args.seed)
    ckpt = (CheckpointManager(args.ckpt_dir, period=args.ckpt_period)
            if args.ckpt_dir else None)
    injector = (FailureInjector([args.inject_failure_at])
                if args.inject_failure_at >= 0 else None)
    if mesh is None:
        def init_state():
            return steps_mod.init_train_state(cfg, args.seed, train, device)
    else:
        def init_state():
            return steps_mod.init_sharded_train_state(cfg, args.seed, train,
                                                      mesh)
    driver = TrainDriver(
        step_fn=step_fn,
        init_state_fn=init_state,
        batch_at=data.batch_at,
        ckpt=ckpt,
        template_fn=lambda: steps_mod.abstract_train_state(cfg, train),
        device=device,
        state_shardings=(steps_mod.train_state_shardings(cfg, mesh, train)
                         if mesh is not None else None),
        mesh=mesh,
        watchdog=Watchdog(),
        failure_injector=injector)
    rep = driver.run(args.steps, log_every=10)
    first = rep.metrics_history[0]["loss"]
    last = rep.metrics_history[-1]["loss"]
    print(f"[train] done: steps={rep.steps_run} restarts={rep.restarts} "
          f"loss {first:.4f} -> {last:.4f} "
          f"stragglers={len(rep.stragglers)}")
    return rep


if __name__ == "__main__":
    main()
