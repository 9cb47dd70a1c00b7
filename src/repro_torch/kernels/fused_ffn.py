"""Launcher for the hand-written fused-FFN kernel (``csrc/fused_ffn.cu``).

Port of ``repro.kernels.fused_ffn.fused_ffn_pallas``: y = act(x @ Wg) *
(x @ Wu) @ Wd (or ungated act(x @ Wu) @ Wd) in one launch, the (T, d_ff)
intermediate kept on chip. The plain PyTorch version is
``ref.fused_ffn_ref``.

The bf16 kernel is output-stationary over a thread-block cluster: the C
blocks of a cluster split the (64-row, d_model) f32 accumulator by d_model
columns, each computes its 64-column piece of every d_ff chunk of h with
``wgmma``, the pieces are all-gathered in distributed shared memory, and
each block multiplies the whole chunk by its columns of Wd. A d_model wider
than one cluster covers (``MAX_COVER``, 4096) is cut into slices, one
cluster each, that recompute the expansion (``Plan.slices``). The plan
splits d_ff into groups whose f32 partials a second pass sums in a fixed
order: at decode to spread the weights over the card, at prefill where the
token tiles' clusters would leave their last wave part empty (``resident``
clusters at once); else the kernel writes nothing but y. The f32 kernel
(tests and the f32 checks) is scalar and splits d_ff over blocks with f32
partials.
``plan`` decides each launch. The launcher in the source takes its 13
numbers as they are and refuses a plan its kernel cannot run safely or
completely (``check_plan`` there), so the CPU tests of ``plan`` pin what
the card runs.

The launch is the operator ``repro_torch::fused_ffn``: its CUDA impl is
``fused_ffn_cuda``, its CPU impl the plain version, its fake impl shape and
dtype only, and its flop formula (``ffn_flops``) the kernel's products,
which the dry run's cost model counts.

``fused_ffn`` is the launch with a gradient (``FusedFFN``): the forward
launches the kernel and saves only its inputs, the backward recomputes the
FFN through its plain version ``ref.fused_ffn_ref`` under grad and returns
that graph's gradients: the exact gradient of the function the kernel
computes (f32 accumulation, h rounded to x's dtype before the down
projection), as the reference's is XLA's autodiff of its plain FFN (its
Pallas kernel has no VJP). No (T, d_ff) hidden is stored between the
passes: the paper's recompute-over-store trade. The recompute runs its
products in f32; in bf16 products (``core.fused_ffn.ffn_reference``) the
gradients of a smoke model differ from the plain version's by a relative
norm of 1.0-1.5e-2, past the 1e-2 they are held to.

``LAUNCHES`` counts the launches this wrapper made, so a run can show that
its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import check_tensor, on_card
from repro_torch.runtime import trace

LAUNCHES = 0

_vp, _int, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# x, wg, wu, wd, ws, y, 5 ints, the plan's 13 numbers (the workspace bytes
# last), the stream: the order of fused_ffn_launch's parameters in
# csrc/fused_ffn.cu.
_ARGTYPES = [_vp] * 6 + [_int] * 17 + [_ll, _vp]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ACT_CODES = {"silu": 0, "gelu": 1, "relu_sq": 2, "relu": 3}

# The bf16 kernel's constants (csrc/fused_ffn.cu) and the card's opt-in
# shared-memory limit per block.
BLOCK_T = 64             # token rows per block (wgmma M)
PIECE = 64               # d_ff columns of h per block per chunk
# output columns per consumer warpgroup; the last, 256, only at a full
# cluster, past what 224 covers there
WIDTHS = (32, 64, 128, 224, 256)
MAX_CLUSTER = 8          # the portable cluster size
MAX_COVER = MAX_CLUSTER * 2 * WIDTHS[-1]   # d_model columns one cluster covers
MAX_PREFILL_GROUPS = 4   # d_ff groups at prefill: partials grow with T
EXP_K = 128              # d_model columns per expansion ring stage
PROJ_K = 32              # d_ff rows per projection ring stage
MAX_STAGES = 6
SMEM_LIMIT = 232_448
# TMA boxes: x (64 rows x 64 columns), Wg / Wu (EXP_K rows x 32 columns),
# and one block's h piece (64 x PIECE)
X_BOX, W_BOX, H_PIECE = 64 * 64 * 2, EXP_K * 32 * 2, 64 * PIECE * 2
BAR_BYTES = 8 * (2 * MAX_STAGES + 2)
# f32 kernel: 16 token rows per block, 128-column sub-blocks, an h tile of
# at most 128 KB of shared memory.
F32_BLOCK_T, F32_COLS, F32_K, F32_H_BYTES = 16, 128, 32, 128 * 1024


@dataclasses.dataclass(frozen=True)
class Plan:
    """What one launch is handed: ``fused_ffn_launch`` takes these numbers."""

    block_t: int            # token rows per block
    cluster: int            # blocks per cluster along d_model (bf16)
    cols: int               # d_model columns per block (bf16: 2 warpgroups)
    chunk: int              # d_ff columns per chunk (bf16) or split (f32)
    stages: int             # ring depth (bf16; 0 for f32)
    groups: int             # d_ff groups (bf16) or splits (f32)
    per_group: int          # chunks per group (f32: 128-column sub-blocks)
    chunks: int             # chunks over d_ff
    smem_bytes: int         # dynamic shared memory per block
    grid: Tuple[int, int, int]
    ws_bytes: int           # f32 partials in device memory; 0: none

    def as_tuple(self) -> Tuple[int, ...]:
        """The 13 numbers, in ``fused_ffn_launch``'s order."""
        return (self.block_t, self.cluster, self.cols, self.chunk,
                self.stages, self.groups, self.per_group, self.chunks,
                self.smem_bytes, *self.grid, self.ws_bytes)

    @property
    def slices(self) -> int:
        """d_model slices (bf16): clusters side by side along grid x, each
        recomputing the expansion of the same d_ff chunks."""
        return self.grid[0] // self.cluster

    @property
    def acc_registers(self) -> int:
        """f32 registers per consumer thread for the accumulators (bf16):
        the output slice (64 x cols / 2 per warpgroup) and [g | u]."""
        return self.cols // 4 + 32

    def tiles(self) -> Iterator[Tuple[int, int, int, Tuple[int, int],
                                      Tuple[int, int]]]:
        """bf16: (block x, token tile, group, d_ff range, d_model range) of
        each block; x is slice x // cluster, cluster rank x % cluster. The
        ranges are half-open and may pass d_ff or d_model (zero-filled
        loads, masked stores)."""
        for group in range(self.groups):
            f0 = group * self.per_group * self.chunk
            f1 = min(self.chunks, (group + 1) * self.per_group) * self.chunk
            for tile in range(self.grid[1]):
                for x in range(self.grid[0]):
                    yield (x, tile, group, (f0, f1),
                           (x * self.cols, (x + 1) * self.cols))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pick_width(d: int) -> Tuple[int, int]:
    """(cluster, columns per warpgroup) for ``d`` columns in bf16: the
    smallest cluster whose blocks cover d with one of ``WIDTHS`` but the
    last, else a full cluster at the last (a smaller cluster at 256 would
    put a token tile on half the SMs)."""
    c = 1
    while c <= MAX_CLUSTER:
        need = _cdiv(d, 2 * c)
        for nw in WIDTHS if c == MAX_CLUSTER else WIDTHS[:-1]:
            if need <= nw:
                return c, nw
        c *= 2
    raise ValueError(f"one cluster covers up to {MAX_COVER} columns, got {d}")


def pick_slices(d: int) -> Tuple[int, int, int]:
    """(slices, cluster, columns per warpgroup) for d_model ``d`` in bf16:
    one slice where a cluster covers d, else the fewest slices of at most
    ``MAX_COVER`` columns, the cluster and width covering one slice."""
    slices = 1 if d <= MAX_COVER else _cdiv(d, MAX_COVER)
    return (slices, *pick_width(_cdiv(d, slices)))


def prefill_per_group(clusters: int, chunks: int, resident: int) -> int:
    """Chunks per d_ff group where the token tiles' ``clusters`` fill the
    card, ``resident`` of them at a time: a plan costs waves x the chunks a
    cluster walks, and d_ff is cut into at most ``MAX_PREFILL_GROUPS``
    groups where that saves a tenth of the cost (the groups' f32 partials
    and their sum take a few per cent)."""
    def cost(per):
        return _cdiv(clusters * _cdiv(chunks, per), resident) * per
    best = chunks
    for g in range(2, MAX_PREFILL_GROUPS + 1):
        per = _cdiv(chunks, g)
        if 10 * cost(per) <= 9 * cost(chunks) and cost(per) < cost(best):
            best = per
    return best


def plan(t: int, d: int, d_ff: int, dtype: torch.dtype, n_sm: int,
         resident: int) -> Plan:
    """The launch for x (t, d), Wg/Wu (d, d_ff), Wd (d_ff, d) on a card of
    ``n_sm`` SMs where ``resident`` clusters of it fit at once (bf16, at
    least 1: ``max_active_clusters``; the f32 plan does not read it)."""
    if dtype == torch.bfloat16:
        if resident < 1:
            raise ValueError(f"need at least 1 resident cluster, got "
                             f"{resident}")
        tiles = _cdiv(t, BLOCK_T)
        slices, c, nw = pick_slices(d)
        chunk = c * PIECE
        chunks = _cdiv(d_ff, chunk)
        # d_ff groups that would fill the card (decode), else groups that
        # fill the last wave of clusters (prefill)
        want = n_sm // (tiles * c * slices)
        per = (prefill_per_group(tiles * slices, chunks, resident)
               if want <= 1 else _cdiv(chunks, min(want, chunks)))
        groups = _cdiv(chunks, per)
        slot = max(EXP_K // 64 * X_BOX + 4 * W_BOX, PROJ_K * 2 * nw * 2)
        h_bytes = c * H_PIECE
        stages = min(MAX_STAGES,
                     (SMEM_LIMIT - 1024 - h_bytes - BAR_BYTES) // slot)
        return Plan(block_t=BLOCK_T, cluster=c, cols=2 * nw, chunk=chunk,
                    stages=stages, groups=groups, per_group=per,
                    chunks=chunks,
                    smem_bytes=1024 + stages * slot + h_bytes + BAR_BYTES,
                    grid=(c * slices, tiles, groups),
                    ws_bytes=4 * groups * t * d if groups > 1 else 0)
    tiles = _cdiv(t, F32_BLOCK_T)
    chunks = _cdiv(d_ff, F32_COLS)
    max_chunks = F32_H_BYTES // (F32_BLOCK_T * 4 * F32_COLS)
    splits = min(chunks, max(_cdiv(chunks, max_chunks), _cdiv(2 * n_sm, tiles)))
    per = _cdiv(chunks, splits)
    groups = _cdiv(chunks, per)
    return Plan(block_t=F32_BLOCK_T, cluster=1, cols=d, chunk=per * F32_COLS,
                stages=0, groups=groups, per_group=per, chunks=chunks,
                smem_bytes=4 * (F32_BLOCK_T * per * F32_COLS
                                + F32_BLOCK_T * F32_K),
                grid=(tiles, groups, 1),
                ws_bytes=4 * groups * tiles * F32_BLOCK_T * d)


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_ffn").lib
    if lib.fused_ffn_launch.argtypes is None:
        lib.fused_ffn_launch.argtypes = _ARGTYPES
        lib.fused_ffn_launch.restype = _int
        lib.fused_ffn_error_string.argtypes = [_int]
        lib.fused_ffn_error_string.restype = ctypes.c_char_p
        lib.fused_ffn_max_clusters.argtypes = [_int] * 3
        lib.fused_ffn_max_clusters.restype = _int
    return lib


def max_active_clusters(t: int, d: int, d_ff: int, n_sm: int) -> int:
    """How many clusters of the bf16 launch can be resident at once on the
    current card (``cudaOccupancyMaxActiveClusters``): asked of the cluster,
    width and shared memory of ``plan`` at one resident cluster, which do
    not depend on residency."""
    pl = plan(t, d, d_ff, torch.bfloat16, n_sm, 1)
    n = _lib().fused_ffn_max_clusters(pl.cluster, pl.cols // 2,
                                      pl.smem_bytes)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed ({-n})")
    return n


_RESIDENT = {}   # (device index, d_model) -> resident clusters


def resident_clusters(dev: torch.device, t: int, d: int, d_ff: int,
                      n_sm: int) -> int:
    """``max_active_clusters`` on ``dev``, asked once per card and d_model
    (the cluster and shared memory depend on d_model alone)."""
    key = (dev.index, d)
    if key not in _RESIDENT:
        with torch.cuda.device(dev):
            _RESIDENT[key] = max_active_clusters(t, d, d_ff, n_sm)
    return _RESIDENT[key]


# The SMs of an H100 SXM and the clusters of 8 resident on it at once: what
# the fake impl plans for, where no card is there to ask.
H100_SMS = 132
H100_RESIDENT = 15


def _check_launch(x, w_gate, w_up, w_down, act) -> Tuple[int, int, int]:
    """What the launcher refuses before it touches the card (the fake impl
    refuses the same): (T, d_model, d_ff)."""
    if x.dim() != 2 or w_up.dim() != 2:
        raise ValueError(f"x must be (T, d_model) and w_up (d_model, d_ff), "
                         f"got {tuple(x.shape)}, {tuple(w_up.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused FFN takes float32 or bfloat16, got {x.dtype}")
    if act not in ACT_CODES:
        raise ValueError(f"unknown act {act!r}; one of {sorted(ACT_CODES)}")
    t, d = x.shape
    f = w_up.shape[1]
    if t < 1 or d % 16 or f % 16:
        raise ValueError(f"need T >= 1 and d_model, d_ff multiples of 16, got "
                         f"T {t}, d_model {d}, d_ff {f}")
    check_tensor(x, "x", x.dtype, (t, d), x.device)
    if w_gate is not None:
        check_tensor(w_gate, "w_gate", x.dtype, (d, f), x.device)
    check_tensor(w_up, "w_up", x.dtype, (d, f), x.device)
    check_tensor(w_down, "w_down", x.dtype, (f, d), x.device)
    return t, d, f


def _check_plan(pl: Plan, dtype: torch.dtype) -> None:
    """The launcher's refusals that a plan from ``plan`` can meet (the fake
    impl refuses the same): a grid dim past 65535, or a bf16 ring of fewer
    than two stages."""
    if dtype == torch.bfloat16:
        refused = pl.grid[1] > 65535 or pl.stages < 2
    else:
        refused = pl.groups > 65535
    if refused:
        raise ValueError(f"fused FFN plan refused: {pl}")


def launch_plan(t: int, d: int, f: int, dtype: torch.dtype,
                dev: torch.device) -> Tuple[int, int, Plan]:
    """(the card's SMs, its resident clusters, the plan) of a launch on
    ``dev``, checked, under the span ``ffn.plan``, whose args are the plan's
    slices, d_ff groups, cluster, grid, columns per block and the resident
    clusters it planned for."""
    with trace.span("ffn.plan") as rec:
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        resident = (resident_clusters(dev, t, d, f, n_sm)
                    if dtype == torch.bfloat16 else 0)
        pl = plan(t, d, f, dtype, n_sm, resident)
        _check_plan(pl, dtype)
        if rec is not None:
            rec.args.update(slices=pl.slices, groups=pl.groups,
                            cluster=pl.cluster, grid=pl.grid, cols=pl.cols,
                            resident=resident)
    return n_sm, resident, pl


def fused_ffn_cuda(x: torch.Tensor, w_gate: Optional[torch.Tensor],
                   w_up: torch.Tensor, w_down: torch.Tensor, *,
                   act: str = "silu") -> torch.Tensor:
    """Launch the fused FFN kernel on CUDA tensors.

    Args:
      x: (T, d_model). w_gate, w_up: (d_model, d_ff); w_gate None for an
        ungated FFN. w_down: (d_ff, d_model). All contiguous, one dtype,
        float32 or bfloat16, starting on 16-byte boundaries; d_model and
        d_ff multiples of 16.
      act: silu | gelu (tanh) | relu_sq | relu.
    Returns: (T, d_model) in x's dtype, on x's device and current stream.
    The card's SMs and the plan are the span ``ffn.plan`` (``launch_plan``).
    """
    global LAUNCHES
    t, d, f = _check_launch(x, w_gate, w_up, w_down, act)
    dev = x.device
    if any(w.data_ptr() % 16 for w in (x, w_gate, w_up, w_down)
           if w is not None):
        raise ValueError("x and the weights must start on 16-byte boundaries "
                         "(TMA)")
    if dev.type != "cuda":
        raise ValueError(f"fused_ffn_cuda needs CUDA tensors, got {dev}")
    _, _, pl = launch_plan(t, d, f, x.dtype, dev)
    ws = torch.empty(pl.ws_bytes // 4, dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_ffn_launch(
            x.data_ptr(), None if w_gate is None else w_gate.data_ptr(),
            w_up.data_ptr(), w_down.data_ptr(),
            ws.data_ptr() if pl.ws_bytes else None, out.data_ptr(),
            _DTYPES[x.dtype], t, d, f, ACT_CODES[act], *pl.as_tuple(),
            stream)
    if err != 0:
        msg = lib.fused_ffn_error_string(err).decode()
        raise RuntimeError(f"fused_ffn kernel launch failed: {msg} ({err}); "
                           f"{pl}")
    LAUNCHES += 1
    return out


# The launch as a PyTorch operator: dispatch, the dry run's fake tensors and
# the cost model see one op with the kernel's own work, not its plain
# version. The CUDA impl launches the kernel (everything that queries the
# card runs inside it); the CPU impl is the plain version. Registered
# through torch.library's define / impl: its dispatch costs a few us a
# call, where the ``custom_op`` decorator's Python layers cost tens on the
# card's host (``probes/op_dispatch.py``), on paths that are host-bound.
OPS = torch.library.Library("repro_torch", "FRAGMENT")
OPS.define("fused_ffn(Tensor x, Tensor? w_gate, Tensor w_up, Tensor w_down, "
           "str act) -> Tensor")


def _fused_ffn_cuda_impl(x, w_gate, w_up, w_down, act):
    return fused_ffn_cuda(x, w_gate, w_up, w_down, act=act)


def _fused_ffn_cpu_impl(x, w_gate, w_up, w_down, act):
    return ref.fused_ffn_ref(x, w_gate, w_up, w_down, act=act)


OPS.impl("fused_ffn", _fused_ffn_cuda_impl, "CUDA")
OPS.impl("fused_ffn", _fused_ffn_cpu_impl, "CPU")


@torch.library.register_fake("repro_torch::fused_ffn")
def _fused_ffn_fake(x, w_gate, w_up, w_down, act):
    t, d, f = _check_launch(x, w_gate, w_up, w_down, act)
    _check_plan(plan(t, d, f, x.dtype, H100_SMS, H100_RESIDENT), x.dtype)
    return torch.empty_like(x)


@register_flop_formula(torch.ops.repro_torch.fused_ffn)
def ffn_flops(x_shape, w_gate_shape, w_up_shape, w_down_shape, act,
              *args, **kwargs) -> int:
    """2 T d f per product: three gated, two ungated."""
    t, d = x_shape
    f = w_up_shape[1]
    return 2 * t * d * f * (3 if w_gate_shape is not None else 2)


class FusedFFN(torch.autograd.Function):
    """``fused_ffn_cuda`` with a gradient through the plain version."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down, act):
        ctx.act = act
        ctx.save_for_backward(x, w_gate, w_up, w_down)
        return _launch(x, w_gate, w_up, w_down, act)

    @staticmethod
    def backward(ctx, grad_y):
        def plain(x, w_gate, w_up, w_down):
            return ref.fused_ffn_ref(x, w_gate, w_up, w_down, act=ctx.act)
        return ref.plain_grads(plain, ctx.saved_tensors,
                               ctx.needs_input_grad[:4], grad_y) + (None,)


def fused_ffn(x: torch.Tensor, w_gate: Optional[torch.Tensor],
              w_up: torch.Tensor, w_down: torch.Tensor, *,
              act: str = "silu") -> torch.Tensor:
    """``fused_ffn_cuda``'s launch, differentiable in x and the weights:
    through ``FusedFFN`` when grad is on and an input requires it, else the
    launch alone (serving)."""
    if _needs_grad(x, w_gate, w_up, w_down):
        return FusedFFN.apply(x, w_gate, w_up, w_down, act)
    return _launch(x, w_gate, w_up, w_down, act)


def _launch(x, w_gate, w_up, w_down, act: str) -> torch.Tensor:
    """The launch through ``repro_torch::fused_ffn`` on a CUDA tensor (on a
    fake one, the op's fake impl); any other tensor goes to
    ``fused_ffn_cuda``, which refuses it."""
    if on_card(x):
        pad = -w_up.shape[1] % 16
        if pad:
            w_gate, w_up, w_down = _pad_d_ff(w_gate, w_up, w_down, pad)
        return torch.ops.repro_torch.fused_ffn.default(x, w_gate, w_up,
                                                      w_down, act)
    return fused_ffn_cuda(x, w_gate, w_up, w_down, act=act)


def _pad_d_ff(w_gate, w_up, w_down, pad: int):
    """The weights with ``pad`` zero d_ff columns (rows of ``w_down``), to
    the multiple of 16 the kernel takes: a d_ff shard of 856 or 1848 on a
    16-way model axis. Exact: a zero column gives act(0) = 0 (every act
    here), and a zero row of ``w_down`` adds nothing."""
    def cols(w):
        return None if w is None else F.pad(w, (0, pad))
    return cols(w_gate), cols(w_up), F.pad(w_down, (0, 0, 0, pad))


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
