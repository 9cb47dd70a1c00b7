"""Launcher for the hand-written flash-attention kernel
(``csrc/flash_attention.cu``).

Port of ``repro.kernels.flash_attention.flash_attention``: online-softmax
attention with causal, sliding-window and logit-softcap masking, the score
matrix never in device memory. The kernel takes the model's (B, T, H, d)
layout and reads KV head ``h // (H // Hkv)`` for query head ``h``, so GQA
needs no repeated K and V. The plain PyTorch versions are
``ref.attention_ref`` and ``ref.mha_ref``.

The bf16 kernel runs one warpgroup per 64-row query tile: ``wgmma`` for
both products with S, P and O in registers, Q and a 2-stage K/V ring loaded
by TMA. ``plan`` states in Python what one bf16 launch is handed (tiles,
padded head dim, ring depth, shared memory, grid and block order), so the
CPU tests can check it.

The launch is the operator ``repro_torch::flash_attention``: its CUDA impl
is ``flash_attention_cuda``, its CPU impl ``ref.mha_ref``, its fake impl
shape and dtype only, and its flop formula (``flash_flops``) the kernel's
products over the pairs the masks leave, which the dry run's cost model
counts.

``flash_attention`` is the launch with a gradient (``FlashAttention``): the
forward launches the kernel and saves only q, k and v, the backward is
``ref.mha_grads_blocked``, the gradient of ``ref.mha_ref`` in closed form a
block of ``block`` queries at a time (the reference trains through XLA's
autodiff of its blocked attention, ``attn_chunk`` keys a block). No
(Tq, Tk) matrix exists in either pass.

``LAUNCHES`` counts the kernel launches this wrapper made, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Iterator, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, ref
from repro_torch.kernels.fused_dsc import check_tensor, on_card

LAUNCHES = 0

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# 4 pointers, 10 ints, 2 floats, the stream: the order of
# flash_attention_launch's parameters in csrc/flash_attention.cu.
_ARGTYPES = [_vp] * 4 + [_int] * 10 + [_float] * 2 + [_vp]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The bf16 kernel's constants (csrc/flash_attention.cu: kBQ, kBK, kBox,
# kStages) and the card's opt-in shared-memory limit per block.
BLOCK_Q = 64
BLOCK_K = 64
BOX = 64            # bf16 columns per TMA box: one 128-byte swizzle row
STAGES = 2
SMEM_LIMIT = 232_448


@dataclasses.dataclass(frozen=True)
class Plan:
    """What one bf16 launch is handed."""

    block_q: int            # query rows per block (one warpgroup)
    block_k: int            # keys per K/V tile
    stages: int             # depth of the K/V ring
    d_pad: int              # head dim padded to a multiple of BOX
    smem_bytes: int         # dynamic shared memory per block
    grid: Tuple[int, int]   # (query tiles, B * H)
    causal: bool            # blocks start from the last query tile

    def tiles(self) -> Iterator[Tuple[int, int]]:
        """(query tile, b * h) of each block in launch order, as the kernel
        maps ``blockIdx``: under a causal mask the last query tiles, which
        see the most keys, come first."""
        n_q, n_bh = self.grid
        for lin in range(n_q * n_bh):
            qt = lin // n_bh
            yield (n_q - 1 - qt if self.causal else qt), lin % n_bh


def plan(b: int, tq: int, tk: int, h: int, hkv: int, d: int,
         causal: bool = True) -> Plan:
    """The bf16 launch for q (b, tq, h, d) and k, v (b, tk, hkv, d). Tk and
    Hkv do not change it: each block walks its own K/V tiles."""
    d_pad = -(-d // BOX) * BOX
    tile = BLOCK_Q * d_pad * 2
    smem = 1024 + tile * (1 + 2 * STAGES) + 8 * (STAGES + 1)
    return Plan(block_q=BLOCK_Q, block_k=BLOCK_K, stages=STAGES, d_pad=d_pad,
                smem_bytes=smem, grid=(-(-tq // BLOCK_Q), b * h),
                causal=causal)


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention").lib
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = _ARGTYPES
        lib.flash_attention_launch.restype = _int
        lib.flash_attention_error_string.argtypes = [_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_bf16_smem_bytes.argtypes = [_int]
        lib.flash_attention_bf16_smem_bytes.restype = _int
    return lib


def kernel_smem_bytes(d: int) -> int:
    """The shared memory the built bf16 kernel asks for at head dim d."""
    return _lib().flash_attention_bf16_smem_bytes(d)


def _check_launch(q, k, v, window, softcap) -> Tuple[int, int, int, int]:
    """What the launcher refuses before it touches the card (the fake impl
    refuses the same): (B, Tq, H, d)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q, k, v must be (B, T, H, d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got {q.dtype}")
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if hkv < 1 or h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} KV heads")
    if d % 16 or not 0 < d <= 256:
        raise ValueError(f"head dim must be a multiple of 16 and <= 256, got {d}")
    if tq < 1 or tk < 1:
        raise ValueError(f"empty sequence: Tq {tq}, Tk {tk}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")
    check_tensor(q, "q", q.dtype, (b, tq, h, d), q.device)
    check_tensor(k, "k", q.dtype, (b, tk, hkv, d), q.device)
    check_tensor(v, "v", q.dtype, (b, tk, hkv, d), q.device)
    return b, tq, h, d


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Launch the flash-attention kernel on CUDA tensors.

    Args:
      q: (B, Tq, H, d); k, v: (B, Tk, Hkv, d), H a multiple of Hkv; all
        contiguous, float32 or bfloat16, d a multiple of 16 and <= 256.
      causal: query i sees keys j <= i. window: keys with i - j < window
        (None: all). softcap: s -> softcap * tanh(s / softcap).
      sm_scale: score scale after the dot (default d ** -0.5).
    Returns: (B, Tq, H, d) in q's dtype, on q's device and current stream.
    """
    global LAUNCHES
    b, tq, h, d = _check_launch(q, k, v, window, softcap)
    tk, hkv = k.shape[1], k.shape[2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on 16-byte boundaries (TMA)")
    scale = float(sm_scale if sm_scale is not None else d ** -0.5)
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, h, hkv, tq, tk, d, int(causal),
            -1 if window is None else int(window), int(softcap is not None),
            float(softcap or 0.0), scale, stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} ({err})")
    LAUNCHES += 1
    return out


# The launch as a PyTorch operator (registered as ``fused_ffn.OPS`` says):
# CUDA impl the kernel, CPU impl the plain version, fake impl shape and
# dtype, and the kernel's own products as its flop formula.
OPS = torch.library.Library("repro_torch", "FRAGMENT")
OPS.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
           "int? window, float? softcap, float? sm_scale) -> Tensor")


def _flash_attention_cuda_impl(q, k, v, causal, window, softcap, sm_scale):
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                softcap=softcap, sm_scale=sm_scale)


def _flash_attention_cpu_impl(q, k, v, causal, window, softcap, sm_scale):
    return ref.mha_ref(q, k, v, causal=causal, window=window,
                       softcap=softcap, sm_scale=sm_scale).contiguous()


OPS.impl("flash_attention", _flash_attention_cuda_impl, "CUDA")
OPS.impl("flash_attention", _flash_attention_cpu_impl, "CPU")


@torch.library.register_fake("repro_torch::flash_attention")
def _flash_attention_fake(q, k, v, causal, window, softcap, sm_scale):
    _check_launch(q, k, v, window, softcap)
    return torch.empty_like(q)


def visible_pairs(tq: int, tk: int, causal: bool,
                  window: Optional[int]) -> int:
    """(query, key) pairs the masks leave, query i at position i: each
    query row sees min(i + 1, window, Tk) keys under a causal mask, else
    min(window, Tk) (the kernel's masks, the positions of a prefill)."""
    w = tk if window is None else min(window, tk)
    if not causal:
        return tq * w
    # rows i < w see i + 1 keys (capped at Tk), the rest see w
    ramp = min(tq, w)
    return ramp * (ramp + 1) // 2 + (tq - ramp) * w


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flash_flops(q_shape, k_shape, v_shape, causal, window, softcap,
                sm_scale, *args, **kwargs) -> int:
    """2 d per visible (query, key) pair for each product, QK^T and PV:
    4 B H d pairs(Tq, Tk)."""
    b, tq, h, d = q_shape
    return 4 * b * h * d * visible_pairs(tq, k_shape[1], causal, window)


class FlashAttention(torch.autograd.Function):
    """``flash_attention_cuda`` with a gradient through the plain version,
    ``block`` queries at a time."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, sm_scale, block):
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      sm_scale=sm_scale)
        ctx.block = block
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, grad_o):
        grads = ref.mha_grads_blocked(*ctx.saved_tensors, grad_o,
                                      block=ctx.block, **ctx.kw)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad)) + (None,) * 5


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    sm_scale: Optional[float] = None,
                    block: int = 1024) -> torch.Tensor:
    """``flash_attention_cuda``'s launch, differentiable in q, k and v:
    through ``FlashAttention`` when grad is on and an input requires it,
    else the launch alone (serving). ``block``: the backward's query
    block."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap,
                                    sm_scale, block)
    return _launch(q, k, v, causal=causal, window=window, softcap=softcap,
                   sm_scale=sm_scale)


def _launch(q, k, v, *, causal, window, softcap, sm_scale) -> torch.Tensor:
    """The launch through ``repro_torch::flash_attention`` on a CUDA tensor
    (on a fake one, the op's fake impl); any other tensor goes to
    ``flash_attention_cuda``, which refuses it."""
    if on_card(q):
        return torch.ops.repro_torch.flash_attention.default(
            q, k, v, causal, window, softcap, sm_scale)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                softcap=softcap, sm_scale=sm_scale)
