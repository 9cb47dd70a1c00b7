"""Launcher for the hand-written fused DSC kernel (``csrc/fused_dsc.cu``).

Port of ``repro.kernels.fused_dsc.fused_dsc_pallas``: one launch computes an
entire inverted-residual block (Expansion -> Depthwise -> Projection, no
residual add) for a batch of NHWC int8 maps, with F1 and F2 kept in shared
memory. The plain PyTorch version is ``ref.fused_dsc_ref``.

The kernel is a persistent grid: each thread block stages the weights once
(transposed, K zero-padded to the int8 MMA depth) and walks units of (image,
tile of ``tile_rows`` output rows), prefetching the next unit's haloed input
strip while it computes the current one. Both 1x1 products run on the int8
tensor cores; the depthwise runs 4 channels a thread. ``plan`` decides
each launch: the tile height, the grid and the shared-memory layout. The
launcher in the source takes its numbers as they are and refuses a plan
whose layout, tiles, units or grid its kernel cannot run, so the CPU tests
of ``plan`` pin what the card runs.

``LAUNCHES`` counts the kernel launches this wrapper made, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Iterator, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import check_tensor
from repro_torch.runtime import trace

LAUNCHES = 0

_vp, _int = ctypes.c_void_p, ctypes.c_int
# 11 pointers, 7 ints, the plan's 12 numbers, 5 ints, the stream: the order
# of fused_dsc_launch's parameters in csrc/fused_dsc.cu.
_ARGTYPES = [_vp] * 11 + [_int] * 24 + [_vp]

# The kernel's constants (csrc/fused_dsc.cu) and the card's shared memory.
THREADS = 256
MAX_BLOCKS_PER_SM = 2       # __launch_bounds__(256, 2)
RUN = 5                     # output columns per depthwise item
MMA_K = 16                  # mma.m16n8k16: K bytes per product
MAX_CIN = 64                # expansion K up to 4 MMA steps
MAX_MID = 4 * THREADS       # one 4-channel group per thread
SMEM_PER_SM = 233_472       # 228 KB
SMEM_RESERVED = 1024        # the runtime's share of it per block
SMEM_LIMIT = 232_448        # 227 KB per block, opted in
N_SM_H100 = 132


@dataclasses.dataclass(frozen=True)
class Plan:
    """What one launch is handed: ``fused_dsc_launch`` takes these numbers."""

    tile_rows: int          # output rows per unit
    n_tiles: int            # units per image
    units: int              # batch * n_tiles
    blocks_per_sm: int      # resident blocks per SM the grid assumes
    grid: int               # persistent blocks: min(units, SMs * blocks_per_sm)
    smem_bytes: int         # dynamic shared memory per block
    kx: int                 # C padded to the MMA depth (expansion K)
    kp: int                 # M padded to the MMA depth (projection K)
    kxs: int                # row stride of x strips and w_exp^T, bytes
    kps: int                # row stride of F2 and w_proj^T, bytes
    wf1: int                # F1 columns: the map, its halo, the run slack
    runs: int               # depthwise runs of RUN columns per output row

    def as_tuple(self) -> Tuple[int, ...]:
        """The 12 numbers, in ``fused_dsc_launch``'s order."""
        return (self.tile_rows, self.n_tiles, self.units, self.blocks_per_sm,
                self.grid, self.smem_bytes, self.kx, self.kp, self.kxs,
                self.kps, self.wf1, self.runs)

    def units_of_block(self, block: int) -> Iterator[int]:
        """The units block ``block`` walks, in its order."""
        return iter(range(block, self.units, self.grid))

    def unit(self, u: int) -> Tuple[int, int]:
        """(image, first output row) of unit ``u``."""
        return u // self.n_tiles, (u % self.n_tiles) * self.tile_rows


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round16(v: int) -> int:
    return _cdiv(v, 16) * 16


def _pad_stride(k: int) -> int:
    """Row stride in bytes for K-major rows of ``k`` bytes (a multiple of
    16): 16 modulo 32, so the 8 rows of an mma fragment hit distinct
    banks."""
    return k + 16 if k % 32 == 0 else k


def _layout(w: int, cin: int, cmid: int, cout: int, s: int, t: int):
    """(smem bytes, kx, kp, kxs, kps, wf1, runs) for tiles of t rows."""
    w2 = _cdiv(w, s)
    kx, kp = _round16(cin), _round16(cmid)
    kxs, kps = _pad_stride(kx), _pad_stride(kp)
    runs = _cdiv(w2, RUN)
    wf1 = max(w + 2, s * (runs * RUN - 1) + 3)
    strip = (t - 1) * s + 3
    smem = (_round16(cmid * kxs) + _round16(cout * kps)
            + _round16(4 * (2 * cmid + 2 * cout))
            + 2 * _round16(_round16(strip * w) * kxs)
            + _round16((strip * wf1 + 1) * cmid)
            + _round16(_round16(t * w2) * kps))
    return smem, kx, kp, kxs, kps, wf1, runs


def check_widths(cin: int, cmid: int, cout: int) -> None:
    """Raise unless the kernel takes these widths."""
    if cin % 8 or cmid % 8 or cout % 8 or cin > MAX_CIN or cmid > MAX_MID:
        raise ValueError(
            f"fused DSC kernel takes C, M, N multiples of 8 with C <= "
            f"{MAX_CIN}, M <= {MAX_MID}; got C {cin}, M {cmid}, N {cout}")


def plan(batch: int, h: int, w: int, cin: int, cmid: int, cout: int,
         stride: int, tile_rows: Optional[int] = None,
         n_sm: int = N_SM_H100) -> Plan:
    """The launch for a (batch, h, w, cin) block of widths cmid, cout.

    ``tile_rows`` None lets the plan pick the tile height: the least work
    per block (strip rows of the expansion at W pixels plus twice the output
    rows at W2 pixels) times the units each resident block walks, ties to
    the taller tile (less halo recomputed). An explicit ``tile_rows`` is
    clamped to the output height. Raises if no tile fits in shared memory.
    """
    check_widths(cin, cmid, cout)
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if min(batch, h, w, n_sm) < 1:
        raise ValueError(f"need batch, h, w and n_sm >= 1, got {batch}, {h}, "
                         f"{w}, {n_sm}")
    if tile_rows is not None and tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    h2, w2 = _cdiv(h, stride), _cdiv(w, stride)
    ts = (range(1, h2 + 1) if tile_rows is None
          else [min(tile_rows, h2)])
    best, best_cost = None, None
    for t in ts:
        smem, kx, kp, kxs, kps, wf1, runs = _layout(w, cin, cmid, cout,
                                                    stride, t)
        if smem > SMEM_LIMIT:
            break
        bps = min(MAX_BLOCKS_PER_SM, SMEM_PER_SM // (smem + SMEM_RESERVED))
        n_tiles = _cdiv(h2, t)
        units = batch * n_tiles
        grid = min(units, n_sm * bps)
        cost = _cdiv(units, grid) * (((t - 1) * stride + 3) * w + 2 * t * w2)
        if best_cost is None or cost <= best_cost:
            best_cost = cost
            best = Plan(tile_rows=t, n_tiles=n_tiles, units=units,
                        blocks_per_sm=bps, grid=grid, smem_bytes=smem, kx=kx,
                        kp=kp, kxs=kxs, kps=kps, wf1=wf1, runs=runs)
    if best is None:
        raise ValueError(
            f"fused DSC block C {cin}, M {cmid}, N {cout}, stride {stride} on "
            f"a {h}x{w} map: no tile of "
            f"{'any height' if tile_rows is None else f'{tile_rows} rows'} "
            f"fits in {SMEM_LIMIT} bytes of shared memory")
    return best


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_dsc").lib
    if lib.fused_dsc_launch.argtypes is None:
        lib.fused_dsc_launch.argtypes = _ARGTYPES
        lib.fused_dsc_launch.restype = _int
        lib.fused_dsc_error_string.argtypes = [_int]
        lib.fused_dsc_error_string.restype = ctypes.c_char_p
        lib.fused_dsc_occupancy.argtypes = [_int, _int, _int]
        lib.fused_dsc_occupancy.restype = _int
    return lib


def occupancy(stride: int, cin: int, smem_bytes: int) -> int:
    """Blocks of the kernel for ``stride`` and ``cin`` that fit on one SM of
    the current card with ``smem_bytes`` of shared memory
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    n = _lib().fused_dsc_occupancy(stride, cin, smem_bytes)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor "
                           f"failed ({-n})")
    return n


def _check_launch(args, stride: int, tile_rows: Optional[int]):
    """What the launcher refuses before it touches the card, ``args`` the
    ten tensors of ``fused_dsc_cuda`` in its order: (B, H, W, C, M, N)."""
    x_q, w_exp, w_dw9, w_proj, b_exp, b_dw, b_proj, m_exp, m_dw, m_proj = args
    if x_q.dim() != 4:
        raise ValueError(f"x_q must be (B, H, W, C), got {tuple(x_q.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if tile_rows is not None and tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    b, h, w, cin = x_q.shape
    if w_exp.dim() != 2 or w_proj.dim() != 2:
        raise ValueError(f"w_exp and w_proj must be 2-d, got "
                         f"{tuple(w_exp.shape)}, {tuple(w_proj.shape)}")
    cmid, cout = w_exp.shape[1], w_proj.shape[1]
    dev = x_q.device
    tensors = ((x_q, "x_q", torch.int8, (b, h, w, cin)),
               (w_exp, "w_exp", torch.int8, (cin, cmid)),
               (w_dw9, "w_dw9", torch.int8, (9, cmid)),
               (w_proj, "w_proj", torch.int8, (cmid, cout)),
               (b_exp, "b_exp", torch.int32, (cmid,)),
               (b_dw, "b_dw", torch.int32, (cmid,)),
               (b_proj, "b_proj", torch.int32, (cout,)),
               (m_exp, "m_exp", torch.float32, (cmid,)),
               (m_dw, "m_dw", torch.float32, (cmid,)),
               (m_proj, "m_proj", torch.float32, (cout,)))
    for t, name, dtype, shape in tensors:
        check_tensor(t, name, dtype, shape, dev)
    check_widths(cin, cmid, cout)
    if any(t.data_ptr() % 16 for t in args):
        raise ValueError("the fused DSC kernel's tensors must start on "
                         "16-byte boundaries")
    if dev.type != "cuda":
        raise ValueError(f"fused_dsc_cuda needs CUDA tensors, got {dev}")
    return b, h, w, cin, cmid, cout


def fused_dsc_cuda(x_q, w_exp, w_dw9, w_proj, b_exp, b_dw, b_proj,
                   m_exp, m_dw, m_proj, *, stride: int,
                   zps: Tuple[int, int, int, int], q6: Tuple[int, int],
                   tile_rows: Optional[int] = None) -> torch.Tensor:
    """Launch the fused DSC kernel on CUDA tensors.

    Args:
      x_q: (B, H, W, C) int8. w_exp: (C, M), w_dw9: (9, M) tap-major,
        w_proj: (M, N), all int8. b_*: int32 biases (zero-point folded).
        m_*: float32 requant multipliers. All contiguous, on one card,
        starting on 16-byte boundaries; C, M, N multiples of 8 (see
        ``check_widths``).
      zps: (zp_in, zp_f1, zp_f2, zp_out). q6: quantized ReLU6 caps (f1, f2).
      tile_rows: output rows per unit; None lets ``plan`` pick.
    Returns: (B, H2, W2, N) int8, on x_q's device and current stream.

    Spans (``runtime.trace``): ``dsc.check`` (``_check_launch``),
    ``dsc.plan`` (the card's SMs and ``plan``, whose numbers are its args),
    ``dsc.launch`` (the output and the ``ctypes`` call).
    """
    global LAUNCHES
    with trace.span("dsc.check"):
        b, h, w, cin, cmid, cout = _check_launch(
            (x_q, w_exp, w_dw9, w_proj, b_exp, b_dw, b_proj, m_exp, m_dw,
             m_proj), stride, tile_rows)
    dev = x_q.device
    with trace.span("dsc.plan") as rec:
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        # may raise
        pl = plan(b, h, w, cin, cmid, cout, stride, tile_rows, n_sm)
        if rec is not None:
            rec.args.update(tile_rows=pl.tile_rows, grid=pl.grid,
                            units=pl.units, smem_bytes=pl.smem_bytes)
    with trace.span("dsc.launch"):
        h2, w2 = -(-h // stride), -(-w // stride)
        out = torch.empty((b, h2, w2, cout), dtype=torch.int8, device=dev)
        lib = _lib()
        _, zp_f1, zp_f2, zp_out = (int(z) for z in zps)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.fused_dsc_launch(
                x_q.data_ptr(), w_exp.data_ptr(), w_dw9.data_ptr(),
                w_proj.data_ptr(), b_exp.data_ptr(), b_dw.data_ptr(),
                b_proj.data_ptr(), m_exp.data_ptr(), m_dw.data_ptr(),
                m_proj.data_ptr(), out.data_ptr(),
                b, h, w, cin, cmid, cout, stride, *pl.as_tuple(),
                zp_f1, zp_f2, zp_out, int(q6[0]), int(q6[1]), stream)
    if err != 0:
        msg = lib.fused_dsc_error_string(err).decode()
        raise RuntimeError(f"fused_dsc kernel launch failed: {msg} ({err}); "
                           f"{pl}")
    LAUNCHES += 1
    return out
