"""Fast-path executor: one lifted stage chain per program fingerprint.

The golden executor (``executor.run_words``) interprets encoded words one
instruction at a time: the right tool for bit-exactness, three orders of
magnitude too slow for 10k-image accuracy runs or serving simulations.
This module closes that gap WITHOUT forking the semantics: a compiled
``Program`` (or ``MultiStreamProgram``) is *lifted* once from its encoded
words into a chain of coarse stage computations on torch tensors, batched
on a leading B axis, and cached under a deterministic program fingerprint.
The numpy interpreter stays the golden reference; every fast-path entry
point is pinned bit-exact against ``run_words`` (the CPU tests run the
schedule x streams x batch matrix; ``chip_smoke.py`` runs it on the card).

Why lifting is sound
--------------------
A schedule changes *traffic and cycles*, never values: fused, rowtile and
layer-by-layer lowerings of a DSC block compute the same function
(``core.fusion``). So the fast path only has to recognise which
network-level stage a CFG unit implements; the instruction kinds are
unambiguous:

* ``CONV_MAC``                      -> 3x3 stem conv
* ``DW_MAC``                        -> DSC block (residual iff ``RES_ADD``)
* ``WINO_MAC``                      -> DSC block, winograd depthwise body
* ``GAP_RST``                       -> GAP + FC classifier unit
* ``EXP_MAC``-only                  -> head 1x1 conv

and then reuse arithmetic that is already proven bit-exact against the
interpreter:

* fused and row-tile DSC stages call ``kernels.ops.dsc_block``: a CUDA
  tensor goes to the hand-written kernel (``csrc/fused_dsc.cu``), a CPU
  tensor to its plain version ``ref.fused_dsc_ref``. A row-tile stage
  passes the ``tile_rows`` it lifted from ``CFG_STRIP``; a fused
  pixel-wise stage has no tile height in its stream and passes ``None``,
  so the kernel's plan picks. Every tiling is bit-identical;
* layer-schedule DSC stages call ``core.dsc.dsc_block_reference``;
* the fused-winograd stage is the folded integer F(2x2,3x3) of
  ``cfu.winograd`` over the whole tile grid (there is no kernel for it);
* stem, head and GAP + FC use the arithmetic of
  ``models.mobilenetv2.forward_int8``.

Integer GEMMs run as float32 matmuls, exact while every partial sum is an
integer below 2^24: a K-term int8 dot is bounded by K * 128^2, so a
contraction is split into chunks of K <= 1023 whose products are summed in
int32 (the VWW network's largest contraction is 576, one chunk). torch has
no int32 matmul on the card, and this is exact on both devices.

No fallback
-----------
The device replaces the reference's backend switch: the cache key is
``(fingerprint, params static key, device type)``, and ``run_fast`` runs on
``cuda`` unless the caller passes ``device="cpu"``. On CUDA a fused or
row-tile stage whose widths the kernel does not take
(``fused_dsc.check_widths``) is refused with ``FastPathError`` when the
program is lifted; it never drops to the plain version. A kernel that
fails to build or launch raises.

Cache key semantics
-------------------
``program_fingerprint`` hashes the encoded words of every stream plus the
canonical memory-layout description: any change to the PE config, the
schedule, a tile size, the partition, or an address moves a CFG/LD/DBUF
word and therefore the fingerprint (it equals the reference's for the same
program). Quantization *constants* (zero points, ReLU6 caps, residual
scales) are closed over as Python scalars, so the key includes the
params' static key: two weight sets with the same quantization domains
share one executor (weights are moved to the device on every call, never
baked), while a different calibration builds a new one instead of
silently reusing stale constants.

Multi-stream programs lift to the sequential composition of their
segments: the frame pipeline changes *when* a core computes, never what;
the ragged-tail padding of ``MultiStreamRunner`` is a per-frame no-op, so
composition is exact for every batch size.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.cfu import isa
from repro_torch.cfu import winograd
from repro_torch.cfu.executor import bind_input
from repro_torch.core import dsc as dsc_mod
from repro_torch.core import quant
from repro_torch.kernels import fused_dsc
from repro_torch.kernels import ops as kops
from repro_torch.models import mobilenetv2 as mnv2

__all__ = [
    "FastPathError", "FastPathExecutor", "program_fingerprint",
    "run_fast", "fast_executor", "cache_info", "clear_cache",
    "set_cache_limit",
]


class FastPathError(ValueError):
    """The instruction stream does not lift to a known stage chain."""


# --------------------------------------------------------------------------
# Fingerprint: encoded words + memory layout, nothing host-side
# --------------------------------------------------------------------------


def _layout_desc(layout) -> str:
    rows = [f"{r.name}|{r.space}|{r.base}|{r.size}"
            for r in sorted(layout.regions.values(), key=lambda r: r.name)]
    rows += [f"dbuf:{name}|{r.space}|{r.base}|{r.size}"
             for name, r in sorted(layout.dbuf.items())]
    rows.append(f"dram={layout.dram_size};sram={layout.sram_size}")
    return ";".join(rows)


def _streams_of(prog) -> List:
    return list(getattr(prog, "streams", None) or [prog])


def program_fingerprint(prog) -> str:
    """Deterministic identity of a compiled program: sha256 over the
    encoded words of every stream plus the canonical layout description.

    Anything that changes execution — schedule, PE config, tile sizes,
    partition, addresses — changes a word or a region and therefore the
    fingerprint; host-side niceties (names in ``meta``) do not.
    """
    h = hashlib.sha256()
    for p in _streams_of(prog):
        h.update(isa.encode_program(p).tobytes())
        h.update(b"|")
    h.update(_layout_desc(prog.meta["layout"]).encode())
    return h.hexdigest()


# --------------------------------------------------------------------------
# Lifting: decoded words -> stage descriptors
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Stage:
    """One lifted network-level stage (the unit between CFG words)."""

    kind: str            # "stem" | "dsc" | "head" | "gapfc"
    block: int           # LD_WGT.block -> params index
    cin: int
    cmid: int
    cout: int
    stride: int
    h: int
    w: int
    residual: bool = False
    impl: str = ""       # dsc: "kernel" | "reference" | "winograd"
    # dsc kernel rows per unit (from CFG_STRIP); None lets the plan pick
    tile_rows: Optional[int] = None
    gap_n: int = 0       # gapfc divisor (GAP_FIN operand)

    def out_shape(self, in_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        h2, w2 = -(-self.h // self.stride), -(-self.w // self.stride)
        if self.kind == "gapfc":
            return (self.cout,)
        return (h2, w2, self.cout)


def _lift_stream(instrs: Sequence[isa.Instr]) -> List[_Stage]:
    """Split one decoded stream at CFG boundaries and classify each unit."""
    units: List[List[isa.Instr]] = []
    for ins in instrs:
        if ins.op == "CFG":
            units.append([ins])
        elif units:
            units[-1].append(ins)
        elif ins.op not in ("CFG_PE", "CFG_CORE", "HALT"):
            raise FastPathError(f"instruction {ins.op} before first CFG")
    stages = []
    for unit in units:
        cfg = unit[0]
        cin, cmid, cout, stride, h, w = cfg.args
        ops = {i.op for i in unit}
        wgt = {i.args[0]: i.args[1] for i in unit if i.op == "LD_WGT"}
        residual = "RES_ADD" in ops
        if "CONV_MAC" in ops:
            stages.append(_Stage("stem", wgt[isa.WGT_CONV], cin, cmid,
                                 cout, stride, h, w))
        elif "GAP_RST" in ops:
            n = next(i.args[0] for i in unit if i.op == "GAP_FIN")
            stages.append(_Stage("gapfc", wgt[isa.WGT_PROJ], cin, cmid,
                                 cout, stride, h, w, gap_n=n))
        elif "DW_MAC" in ops:
            strip = next((i.args[0] for i in unit if i.op == "CFG_STRIP"),
                         0)
            if strip:                    # rowtile: invert (t-1)*s + k
                impl, tr = "kernel", max(1, (strip - isa.KERNEL) // stride
                                         + 1)
            elif "LD_WIN" in ops:        # fused pixel-wise: no tile height
                impl, tr = "kernel", None
            else:                        # layer-dram / layer-sram
                impl, tr = "reference", None
            stages.append(_Stage("dsc", wgt[isa.WGT_EXP], cin, cmid, cout,
                                 stride, h, w, residual=residual,
                                 impl=impl, tile_rows=tr))
        elif "WINO_MAC" in ops:
            # fused-winograd: no DW_MAC/LD_WIN in the stream, so this must
            # be checked before the EXP_MAC-only head classification
            stages.append(_Stage("dsc", wgt[isa.WGT_EXP], cin, cmid, cout,
                                 stride, h, w, residual=residual,
                                 impl="winograd",
                                 tile_rows=winograd.TILE))
        elif "EXP_MAC" in ops:
            stages.append(_Stage("head", wgt[isa.WGT_EXP], cin, cmid,
                                 cout, stride, h, w))
        else:
            raise FastPathError(
                f"CFG unit with ops {sorted(ops)} matches no known stage")
    return stages


def _lift_program(prog) -> List[_Stage]:
    stages: List[_Stage] = []
    for p in _streams_of(prog):
        stages.extend(
            _lift_stream(isa.decode_words(isa.encode_program(p))))
    return stages


# --------------------------------------------------------------------------
# Stage descriptors -> torch stage bodies (weights are call arguments)
# --------------------------------------------------------------------------

_STAGE_ARRAYS = {
    "stem": ("w_conv", "b_conv", "m_exp"),
    "dsc": ("w_exp", "w_dw", "w_proj", "b_exp", "b_dw", "b_proj",
            "m_exp", "m_dw", "m_proj"),
    "head": ("w_exp", "b_exp", "m_exp"),
    "gapfc": ("w_proj", "b_proj", "m_proj"),
}


def _scale_bits(qp) -> str:
    return float(np.asarray(qp.scale)).hex()


def _static_key_of(stage: _Stage, p) -> Tuple:
    """The quantization constants a stage closes over (part of the cache
    key: same fingerprint + same constants => same executor)."""
    if stage.kind == "stem":
        return ("stem", p.qp_in.zero_point, p.qp_f1.zero_point, p.q6_f1)
    if stage.kind == "head":
        return ("head", p.qp_f1.zero_point, p.q6_f1)
    if stage.kind == "gapfc":
        return ("gapfc", p.qp_out.zero_point)
    spec = p.spec
    return ("dsc", spec.cin, spec.cmid, spec.cout, spec.stride,
            p.qp_in.zero_point, p.qp_f1.zero_point, p.qp_f2.zero_point,
            p.qp_out.zero_point, p.q6_f1, p.q6_f2,
            _scale_bits(p.qp_in), _scale_bits(p.qp_out))


def _check_stage_params(stage: _Stage, p):
    """Fail fast (and clearly) when params don't match the lifted stream."""
    need = {"stem": "w_conv", "dsc": "w_dw", "head": "w_exp",
            "gapfc": "w_proj"}[stage.kind]
    if getattr(p, need, None) is None:
        raise FastPathError(
            f"params[{stage.block}] ({type(p).__name__}) lacks {need!r} "
            f"for a lifted {stage.kind} stage")
    if stage.kind == "dsc" and (p.spec.cin, p.spec.cmid, p.spec.cout,
                                p.spec.stride) != (stage.cin, stage.cmid,
                                                   stage.cout,
                                                   stage.stride):
        raise FastPathError(
            f"params[{stage.block}] spec {p.spec} mismatches lifted DSC "
            f"geometry ({stage.cin},{stage.cmid},{stage.cout},"
            f"s{stage.stride})")


# float32 holds every integer of magnitude < 2^24 exactly, and a K-term
# int8 dot is bounded by K * 128^2 — so f32 GEMM is bit-exact iff:
_F32_EXACT_LIMIT = 1 << 24


def _f32_gemm_exact(k: int) -> bool:
    """True when a K-term int8 x int8 contraction is exact in float32."""
    return k * 128 * 128 < _F32_EXACT_LIMIT



# the largest K whose int8 contraction is exact in float32
_F32_EXACT_K = (_F32_EXACT_LIMIT - 1) // (128 * 128)


def mm(a: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """int8 (..., K) @ int8 (K, M) -> int32, exact on both devices: one
    float32 product per chunk of K that passes ``_f32_gemm_exact``, cast to
    int32 and summed."""
    out = None
    for k0 in range(0, k, _F32_EXACT_K):
        part = quant.int8_matmul(a[..., k0:k0 + _F32_EXACT_K],
                                 w[k0:k0 + _F32_EXACT_K])
        out = part if out is None else out + part
    return out


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # the winograd transforms: small integer operands, exact in float32
    # unless TF32 rounds them
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("fused-winograd stage: torch.backends.cuda.matmul"
                           ".allow_tf32 is True; TF32 rounds the operands "
                           "and the transform is no longer exact")
    return a @ b


def check_stage_device(stage: _Stage, device) -> None:
    """Refuse, at lift time, a stage the device cannot run as lifted.

    On CUDA a fused or row-tile DSC stage runs the hand-written kernel,
    which takes only some widths; the rest raise ``FastPathError`` naming
    the limit instead of dropping to the plain version.
    """
    if (torch.device(device).type == "cuda" and stage.kind == "dsc"
            and stage.impl == "kernel"):
        try:
            fused_dsc.check_widths(stage.cin, stage.cmid, stage.cout)
        except ValueError as e:
            raise FastPathError(
                f"dsc stage of block {stage.block} cannot run on the card: "
                f"{e}") from None


def _build_stage_fn(stage: _Stage, p, device: torch.device):
    """Close over STATIC quantization constants only; weight tensors come
    in per call (dict ``w``), so one executor serves any weight values in
    the same quantization domains. Every body maps a (B, H, W, C) int8
    batch on ``device``."""
    if stage.kind == "stem":
        zp_in, zp_f1 = p.qp_in.zero_point, p.qp_f1.zero_point
        q6, s, cin = p.q6_f1, stage.stride, stage.cin

        def stem_fn(x, w):
            # im2col: 9 strided taps concatenated on the channel axis, then
            # ONE (B*H2*W2, 9*Cin) GEMM
            xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=zp_in)
            patches = mnv2._im2col3x3(xp, s)
            acc = mm(patches, w["w_conv"].reshape(9 * cin, -1), 9 * cin)
            return quant.requantize(acc + w["b_conv"], w["m_exp"], zp_f1,
                                    relu=True, relu6_max_q=q6)
        return stem_fn

    if stage.kind == "head":
        zp_f1, q6, cin = p.qp_f1.zero_point, p.q6_f1, stage.cin

        def head_fn(x, w):
            acc = mm(x, w["w_exp"], cin) + w["b_exp"]
            return quant.requantize(acc, w["m_exp"], zp_f1, relu=True,
                                    relu6_max_q=q6)
        return head_fn

    if stage.kind == "gapfc":
        zp_out, cin = p.qp_out.zero_point, stage.cin
        # the divisor on the data's device: CUDA divides by a CPU scalar as
        # a multiply by its reciprocal, which is not exact
        n = torch.tensor(float(stage.gap_n), dtype=torch.float32,
                         device=device)

        def gapfc_fn(x, w):
            # int32 sum / n in float32, rounded half to even
            g = x.to(torch.int32).sum(dim=(1, 2), dtype=torch.int32)
            g = torch.round(g.to(torch.float32) / n)
            g = torch.clamp(g, -128, 127).to(torch.int8)
            acc = mm(g, w["w_proj"], cin) + w["b_proj"]
            return quant.requantize(acc, w["m_proj"], zp_out)
        return gapfc_fn

    # --- DSC block ---------------------------------------------------------
    residual, p0 = stage.residual, p
    cin, cmid, cout = stage.cin, stage.cmid, stage.cout
    if stage.impl == "winograd":
        # Same folded integer F(2x2,3x3) as executor._op_wino_mac, over the
        # whole tile grid with strided slices. Every transform value and
        # partial sum is an integer bounded by winograd.accumulator_bound()
        # < 2^24, so the float32 products are exact, and Y4 is a multiple
        # of 4, so the floor division is exact.
        assert winograd.accumulator_bound() < _F32_EXACT_LIMIT
        zp_f1 = p.qp_f1.zero_point
        zp_f2, zp_out = p.qp_f2.zero_point, p.qp_out.zero_point
        q6_f1, q6_f2 = p.q6_f1, p.q6_f2
        bt, g2, at = (torch.tensor(m, dtype=torch.float32, device=device)
                      for m in (winograd.BT, winograd.G2, winograd.AT))

        def dsc_wino_fn(x, w):
            b, h, wd = x.shape[0], x.shape[1], x.shape[2]
            f1 = quant.requantize(mm(x, w["w_exp"], cin) + w["b_exp"],
                                  w["m_exp"], zp_f1, relu=True,
                                  relu6_max_q=q6_f1)
            h2, w2 = h, wd                       # stride 1 by construction
            ty, tx = -(-h2 // 2), -(-w2 // 2)
            # zp_f1 halo + right/bottom overhang padding to an even tile
            # grid, identical to the reference's padded F1 (overhang taps
            # fall outside the map, which IS the zero-point fill)
            f1p = F.pad(f1, (0, 0, 1, 1 + 2 * tx - w2, 1, 1 + 2 * ty - h2),
                        value=zp_f1)
            taps = [f1p[:, dy:dy + 2 * (ty - 1) + 1:2,
                        dx:dx + 2 * (tx - 1) + 1:2, :]
                    for dy in range(4) for dx in range(4)]
            # (B, ty, tx, C, 4, 4): the channel before the window axes
            d = torch.stack(taps, dim=-1).reshape(b, ty, tx, cmid, 4, 4)
            wdw = w["w_dw"].to(torch.float32).permute(2, 0, 1)   # (C, 3, 3)
            u4 = _f32_matmul(_f32_matmul(g2, wdw), g2.T)         # (C, 4, 4)
            v = _f32_matmul(_f32_matmul(bt, d.to(torch.float32)), bt.T)
            y4 = _f32_matmul(_f32_matmul(at, v * u4), at.T)      # (.., 2, 2)
            tiles = torch.div(y4.to(torch.int32), 4, rounding_mode="floor")
            full = tiles.permute(0, 1, 4, 2, 5, 3).reshape(
                b, 2 * ty, 2 * tx, cmid)[:, :h2, :w2]
            f2 = quant.requantize(full + w["b_dw"], w["m_dw"], zp_f2,
                                  relu=True, relu6_max_q=q6_f2)
            y = quant.requantize(mm(f2, w["w_proj"], cmid) + w["b_proj"],
                                 w["m_proj"], zp_out)
            if residual:
                y = dsc_mod.residual_add_q(y, x, p0)
            return y
        return dsc_wino_fn

    if stage.impl == "kernel":
        zps = (p.qp_in.zero_point, p.qp_f1.zero_point,
               p.qp_f2.zero_point, p.qp_out.zero_point)
        q6 = (p.q6_f1, p.q6_f2)
        stride, tile_rows = stage.stride, stage.tile_rows

        def dsc_kernel_fn(x, w):
            y = kops.dsc_block(
                x, w["w_exp"], w["w_dw"].reshape(9, cmid), w["w_proj"],
                w["b_exp"], w["b_dw"], w["b_proj"],
                w["m_exp"], w["m_dw"], w["m_proj"],
                stride=stride, zps=zps, q6=q6, tile_rows=tile_rows)
            if residual:
                y = dsc_mod.residual_add_q(y, x, p0)
            return y
        return dsc_kernel_fn

    def dsc_ref_fn(x, w):
        # same stage arithmetic as the layer-by-layer oracle, with the
        # weight tensors swapped for the call's
        pt = dataclasses.replace(p0, **{k: w[k]
                                        for k in _STAGE_ARRAYS["dsc"]})
        return dsc_mod.dsc_block_reference(x, pt)
    return dsc_ref_fn


_DTYPES = {"w": torch.int8, "b": torch.int32, "m": torch.float32}


def _stage_weights(stage: _Stage, p,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    """The stage's weight tensors on ``device``, copied there on every
    call (numpy arrays or tensors on any device)."""
    out = {}
    for name in _STAGE_ARRAYS[stage.kind]:
        v, dt = getattr(p, name), _DTYPES[name[0]]
        out[name] = (v.to(device=device, dtype=dt).contiguous()
                     if isinstance(v, torch.Tensor)
                     else torch.tensor(np.asarray(v), dtype=dt,
                                       device=device))
    return out


def _bind(x_q, meta, device: torch.device) -> Tuple[torch.Tensor, bool]:
    """``executor.bind_input``'s conventions and checks (single frame or
    leading batch axis) for a tensor or an array, as int8 on ``device``."""
    if isinstance(x_q, torch.Tensor):
        n_in = len(meta["in_shape"])
        if x_q.dim() not in (n_in, n_in + 1):
            raise ValueError(f"input ndim {x_q.dim()}, expected {n_in} or "
                             f"{n_in + 1} (batched)")
        batched = x_q.dim() == n_in + 1
        x = x_q if batched else x_q[None]
        r_in = meta["layout"].regions[meta["in_region"]]
        if x[0].numel() != r_in.size:
            raise ValueError(f"input has {x[0].numel()} bytes, region "
                             f"{r_in.name} holds {r_in.size}")
        return x.to(device=device, dtype=torch.int8).contiguous(), batched
    x, batched = bind_input(x_q, meta)
    return torch.tensor(x, device=device), batched


# --------------------------------------------------------------------------
# The executor object + fingerprint cache
# --------------------------------------------------------------------------


class FastPathExecutor:
    """One lifted program on one device; ``__call__`` matches
    ``run_program`` / ``run_multistream`` (minus stats/tracer: the
    interpreter owns those) and returns an int8 tensor on that device.
    """

    def __init__(self, prog, params: Sequence, device=None):
        self.meta = prog.meta
        self.device = resolve_device("cuda" if device is None else device)
        self.fingerprint = program_fingerprint(prog)
        self.stages = _lift_program(prog)
        if not self.stages:
            raise FastPathError("program lifts to zero stages")
        for st in self.stages:
            _check_stage_params(st, params[st.block])
            check_stage_device(st, self.device)
        self.static_key = tuple(_static_key_of(st, params[st.block])
                                for st in self.stages)
        # shape continuity: lift-time validation, not run-time surprise
        shape = tuple(self.meta["in_shape"])
        for st in self.stages:
            if st.kind != "gapfc" and shape != (st.h, st.w, st.cin):
                raise FastPathError(
                    f"stage {st.kind}@block{st.block} wants input "
                    f"({st.h},{st.w},{st.cin}), chain carries {shape}")
            shape = st.out_shape(shape)
        out_shape = tuple(self.meta["out_shape"])
        if int(np.prod(shape)) != int(np.prod(out_shape)):
            raise FastPathError(
                f"lifted chain ends at {shape}, program output region "
                f"holds {out_shape}")
        self._fns = [_build_stage_fn(st, params[st.block], self.device)
                     for st in self.stages]

    def weights_of(self, params: Sequence) -> List[Dict[str, torch.Tensor]]:
        return [_stage_weights(st, params[st.block], self.device)
                for st in self.stages]

    def __call__(self, x_q, params: Sequence) -> torch.Tensor:
        x, batched = _bind(x_q, self.meta, self.device)
        y = x
        for fn, w in zip(self._fns, self.weights_of(params)):
            y = fn(y, w)
        y = y.reshape((x.shape[0],) + tuple(self.meta["out_shape"]))
        return y if batched else y[0]


_CACHE: "OrderedDict[Tuple[str, Tuple, str], FastPathExecutor]" = \
    OrderedDict()
_HITS = 0
_MISSES = 0
_EVICTIONS = 0
#: Default cache capacity. Generous (an executor is small; the VWW matrix
#: tests build a few dozen) but BOUNDED: long serving runs cycling through
#: many compiled design points do not grow the cache without limit.
#: ``set_cache_limit`` reconfigures it.
_DEFAULT_CACHE_LIMIT = 128
_LIMIT = _DEFAULT_CACHE_LIMIT


def set_cache_limit(n: int) -> None:
    """Bound the cache to ``n`` executors (LRU eviction).

    Shrinking below the current size evicts the least-recently-used
    entries immediately. Eviction only drops the cached executor; a later
    request for the same program re-lifts, bit-exact.
    """
    global _LIMIT
    if n < 1:
        raise ValueError(f"cache limit must be >= 1, got {n}")
    _LIMIT = n
    _evict_to_limit()


def _evict_to_limit() -> None:
    global _EVICTIONS
    while len(_CACHE) > _LIMIT:
        _CACHE.popitem(last=False)
        _EVICTIONS += 1


def fast_executor(prog, params: Sequence, device=None) -> FastPathExecutor:
    """Cache lookup: (program fingerprint, params static key, device type)
    -> executor.

    A hit returns the SAME object; a changed PE config, schedule, layout,
    quantization domain or device misses and lifts fresh, never stale
    reuse. ``device`` None means ``cuda``, which raises without a card.
    """
    global _HITS, _MISSES
    dev = resolve_device("cuda" if device is None else device)
    fp = program_fingerprint(prog)
    # cheap pre-check: an executor under this fingerprint knows its lifted
    # stages, so reuse them to key the params constants without re-lifting
    for (cfp, _, cdev), ex in _CACHE.items():
        if cfp == fp and cdev == dev.type:
            key = (fp, tuple(_static_key_of(st, params[st.block])
                             for st in ex.stages), dev.type)
            hit = _CACHE.get(key)
            if hit is not None:
                _HITS += 1
                _CACHE.move_to_end(key)     # LRU: refresh recency
                return hit
            break
    ex = FastPathExecutor(prog, params, device=dev)
    _CACHE[(fp, ex.static_key, dev.type)] = ex
    _MISSES += 1
    _evict_to_limit()
    return ex


def run_fast(prog, x_q, params: Sequence, device=None) -> torch.Tensor:
    """Drop-in fast-path twin of ``run_program`` / ``run_multistream``:
    same input conventions (single frame or batch), same values, computed
    by the cached stage chain instead of the word interpreter. Returns an
    int8 tensor on ``device`` (``cuda`` unless the caller asks for the
    CPU)."""
    return fast_executor(prog, params, device=device)(x_q, params)


def cache_info() -> Dict[str, object]:
    return {"size": len(_CACHE), "hits": _HITS, "misses": _MISSES,
            "evictions": _EVICTIONS, "limit": _LIMIT,
            "fingerprints": sorted({fp for fp, *_ in _CACHE})}


def clear_cache() -> None:
    global _HITS, _MISSES, _EVICTIONS, _LIMIT
    _CACHE.clear()
    _HITS = 0
    _MISSES = 0
    _EVICTIONS = 0
    _LIMIT = _DEFAULT_CACHE_LIMIT
