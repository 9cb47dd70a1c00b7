"""Exact-integer Winograd F(2x2,3x3) for the depthwise stage.

The ``fused-winograd`` schedule replaces the direct 3x3 depthwise
(9 multiplies per output element) with Winograd F(2x2,3x3): each 2x2
output tile is computed from a 4x4 input window with 16 elementwise
multiplies — 4 effective multiplies per output, a 2.25x reduction in
multiply work (the WinoFPGA structure, arXiv CFU-Playground line).

The standard real-valued transform uses G with 1/2 entries; folding a
factor of 2 into G keeps EVERYTHING integral:

    V  = Bᵀ d B            Bᵀ entries in {0, ±1}
    Ũ  = (2G) g (2G)ᵀ      = 4 · G g Gᵀ, integer because 2G is integer
    M  = V ∘ Ũ             elementwise (the 16-multiply array)
    Y₄ = Aᵀ M A            = 4 · (d ⊛ g)   — four times the direct conv
    Y  = Y₄ / 4            exact: Y₄ is by construction a multiple of 4

so the schedule is BIT-IDENTICAL to ``core.dsc``'s direct depthwise —
there is no approximation to bound, only an int32 accumulator headroom
obligation, checked *statically* by :func:`check_exact` from the worst
case of the operand bit widths (for int8 activations/weights the peak
intermediate is |Y₄| <= 9 · (4·2⁷) · (9·2⁷) ≈ 5.3e6, far inside int32).
A configuration whose folded transform could overflow must be REFUSED
at compile time (``ValueError``) rather than silently approximated —
that is the differential policy the compiler enforces.

The golden executor (``executor._op_wino_mac``) and the fast path's
jitted stage body both compute through :func:`wino_dw_tiles` /
:data:`BT`/:data:`G2`/:data:`AT`, so there is exactly one definition of
the arithmetic to test: the hypothesis property in
``tests/test_cfu_properties.py`` pins tile == direct conv for random
int8 data over every tile position, overhang and padding included.
"""

from __future__ import annotations

import numpy as np

# Transform matrices, folded to integers. BT/AT are the standard
# F(2x2,3x3) matrices; G2 = 2·G so the weight transform stays integral.
BT = np.array([[1, 0, -1, 0],
               [0, 1, 1, 0],
               [0, -1, 1, 0],
               [0, 1, 0, -1]], dtype=np.int32)
G2 = np.array([[2, 0, 0],
               [1, 1, 1],
               [1, -1, 1],
               [0, 0, 2]], dtype=np.int32)
AT = np.array([[1, 1, 1, 0],
               [0, 1, -1, -1]], dtype=np.int32)

TILE = 2           # output tile edge (F(2x2, 3x3))
WIN = 4            # input window edge per tile
MULS_PER_TILE = WIN * WIN   # the elementwise multiply array, per channel

INT32_MAX = (1 << 31) - 1


def accumulator_bound(in_bits: int = 8, w_bits: int = 8) -> int:
    """Worst-case |Y₄| of the folded transform for signed operand widths.

    Each transform stage is a signed combination of the previous one, so
    the peak magnitude multiplies by the largest row absolute sum (the
    induced inf-norm); the elementwise stage multiplies the two bounds.
    """
    d_max = 1 << (in_bits - 1)
    g_max = 1 << (w_bits - 1)
    v_max = int(np.abs(BT).sum(axis=1).max()) ** 2 * d_max
    u_max = int(np.abs(G2).sum(axis=1).max()) ** 2 * g_max
    m_max = v_max * u_max
    return int(np.abs(AT).sum(axis=1).max()) ** 2 * m_max


def check_exact(in_bits: int = 8, w_bits: int = 8) -> None:
    """Statically refuse any config whose folded transform could overflow.

    The differential policy: ``fused-winograd`` is exact or it does not
    compile. For the repo's int8 pipeline the bound is ~5.3e6 and this
    always passes; it is the contract that keeps a future wider-operand
    path from silently approximating.
    """
    bound = accumulator_bound(in_bits, w_bits)
    if bound > INT32_MAX:
        raise ValueError(
            f"fused-winograd: folded F(2x2,3x3) transform can reach "
            f"|acc|={bound} > int32 for s{in_bits} x s{w_bits} operands — "
            f"refusing (exactness is the contract; use fused/fused-rowtile)")


def weight_transform(g: np.ndarray) -> np.ndarray:
    """(3, 3, C) int8/int32 depthwise taps -> (4, 4, C) int32 Ũ = (2G)g(2G)ᵀ."""
    g32 = np.asarray(g, dtype=np.int32)
    return np.einsum("ij,jkc,lk->ilc", G2, g32, G2)


def wino_dw_tiles(d: np.ndarray, u4: np.ndarray) -> np.ndarray:
    """Exact F(2x2,3x3) on a batch of 4x4 windows.

    ``d``  — (..., 4, 4, C) int input windows (zero-point-padded like the
             direct path pads F1); ``u4`` — (4, 4, C) transformed weights
             from :func:`weight_transform`. Returns (..., 2, 2, C) int32,
             equal to the direct 3x3 valid conv of each window.
    """
    d32 = np.asarray(d, dtype=np.int32)
    v = np.einsum("ij,...jkc,lk->...ilc", BT, d32, BT)
    m = v * u4
    y4 = np.einsum("ij,...jkc,lk->...ilc", AT, m, AT)
    # y4 == 4 * conv exactly, so floor division is exact (negatives too)
    return y4 // 4
