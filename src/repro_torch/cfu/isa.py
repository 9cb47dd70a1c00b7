"""CFU instruction set: encodings, assembler, disassembler.

Every instruction is one 64-bit word:

    [63:56]  opcode (8 bits)
    [55:0]   operand fields, packed MSB-first in the order given by
             ``FIELD_SPECS[op]`` (a list of (field_name, bit_width))

The encoding is total — ``decode(encode(i)) == i`` for every legal
instruction, and the golden executor runs *from the encoded words*
(``executor.run_words``), so the binary format provably carries the whole
program. A text form (one mnemonic + comma-separated fields per line) is
provided for debugging and round-trips through ``program_from_asm``.

Operand value tables
--------------------
base registers : IN=0  OUT=1  F1=2  F2=3
memory spaces  : DRAM=0  SRAM=1
LD_WGT.which   : EXP=0  DW=1  PROJ=2  CONV=3 (stem 3x3 standard conv)
EXP_MAC.mode   : WIN=0 (3x3 window)  VEC=1 (single pixel, layer-by-layer)
REQUANT.stage  : F1=0  F2=1  OUT=2

The depthwise kernel is fixed at 3x3 (the paper's engines); ``CFG`` carries
no kernel field.

Full-network extension
----------------------
Four opcodes lift the stream from DSC-chain-only to a whole VWW inference:

* ``CONV_MAC``  — standard 3x3 convolution over the loaded window using the
  CONV weight set (the network stem); all taps and input channels reduce
  into one length-``cmid`` accumulator.
* ``GAP_RST`` / ``GAP_ACC`` / ``GAP_FIN`` — global average pooling: reset
  the int32 pooling accumulator, add the last-loaded channel vector, and
  finalize (``round(acc / n)`` in float32, clip to int8 — bit-identical to
  the scalar-core reference). ``GAP_FIN`` leaves the pooled vector on the
  projection input port, so the FC head is ``GAP_FIN`` -> ``PROJ_MAC`` ->
  ``REQUANT OUT``.
* ``CFG_PE``    — latch the engine counts (expansion window engines,
  depthwise lanes, projection engines). Architecturally a no-op (the golden
  executor ignores it); the timing model uses it to scale per-stage costs,
  which is how cycles-vs-PE-count sweeps are carried *in the program*.

Row-tile fusion extension
-------------------------
``CFG_STRIP rows`` puts the F1 base register into *strip mode*: the F1 map
is backed by a rolling buffer of ``rows`` feature-map rows, and every F1
row coordinate is addressed modulo ``rows`` (a circular line buffer — the
standard windowing-engine structure, here applied to the expanded map).
The fused-rowtile schedule sets ``rows = (tile_rows-1)*stride + 3`` so a
tile's full depthwise halo is resident while expansion rows older than the
halo are overwritten in place; halo rows carried between consecutive tiles
(two rows at stride 1, one row at stride 2) are *reused*, never
recomputed. ``rows = 0`` (and every ``CFG``) returns F1 to plain
row-major addressing.

Heterogeneous multi-stream extension
------------------------------------
Two CFG words carry the per-core configuration of a frame-pipelined
multi-core compile *in the stream itself* (a stream stays a complete
description of its hardware point):

* ``CFG_CORE core, n_cores`` — which pipeline-stage slot this stream
  occupies. Architecturally informational (the golden executor latches it
  for diagnostics); it is what makes a segment stream self-describing when
  dumped and reloaded on its own.
* ``CFG_DBUF reg, space, base0, base1`` — bind a base register to a
  *double-buffered* boundary region: the ping copy at ``base0`` and the
  pong copy at ``base1``. The executing core resolves the pair against its
  frame-parity latch (even rounds read/write ping, odd rounds pong), so a
  producer core can fill one copy while its consumer drains the other —
  the inter-stage streaming of Bai et al. (arXiv:1809.01536), here applied
  to the inter-core boundary maps of a partitioned network. Addresses are
  24-bit (the two of them must share the word with reg+space); the
  compiler validates placements fit.

Winograd depthwise extension
----------------------------
Two words carry the ``fused-winograd`` schedule (WinoFPGA-style F(2x2,3x3)
depthwise with 2x2->4x4 tile stitching):

* ``CFG_WINO tiles_y, tiles_x, shared`` — arm the Winograd depthwise unit
  for the current block: the output map is stitched from ``tiles_y x
  tiles_x`` 2x2 tiles, each computed from a 4x4 window of the expanded F1
  map via the exact-integer folded transforms (BᵀdB with ±1 entries,
  (2G)g(2G)ᵀ = 4·GgGᵀ kept integral, Y = Aᵀ(V∘Ũ)A / 4 — the division is
  exact, so the unit is bit-identical to the direct 3x3 depthwise).
  ``shared`` latches the shared dw/pw engine variant: while the Winograd
  multiply array is armed, its idle lanes are reused by the pointwise
  projection GEMM (a timing-model property; values never change).
  Every ``CFG`` disarms the unit.
* ``WINO_MAC oy, ox`` — produce the depthwise accumulator for output pixel
  ``(oy, ox)``: the unit computes (or reuses, for the other three pixels of
  the same 2x2 tile) the tile at ``(oy//2, ox//2)`` — 16 elementwise
  multiplies per channel instead of the direct unit's 36 — and latches
  ``Y[oy%2, ox%2] + b_dw`` on the depthwise accumulator, feeding the same
  ``REQUANT F2`` -> ``PROJ_MAC`` tail as ``DW_MAC``. Out-of-map window taps
  read the F1 zero point, exactly like the direct path's padding.

Reliability extension
---------------------
Detection words for the fault-injection campaigns (``cfu/faults.py``).
All are opt-in: an unprotected stream encodes byte-identically to one without
the extension.

* **Word parity** — every field layout leaves bit 0 of the 64-bit word
  unused (CFG, the widest, packs 54 bits down to bit 2), so bit 0 carries
  an even-parity bit over the whole word when ``program.meta["parity"]``
  is set. ``encode_program`` stamps it; the executor verifies every word
  before decoding, so ANY single-bit flip in an encoded instruction —
  opcode byte, operand field, unused gap, or the parity bit itself — is
  detected before it can execute. The disassembler ignores bit 0, so a
  parity-stamped word decodes to the same ``Instr``.
* ``CHK_WGT which, block, sum`` — verify that the additive byte checksum
  (uint8 sum mod 2^32) of the named weight tensor equals the 32-bit
  ``sum`` operand stamped at protect time from the pristine params. A
  single bit flip in a weight byte changes the sum by exactly ±2^k mod
  2^32, so detection of single-bit weight faults is exact, not
  probabilistic. Mismatch raises ``faults.FaultDetected``.
* ``CHK_SAVE reg, chk`` / ``CHK_CMP reg, chk`` — checksum the feature-map
  region bound to ``reg`` into check register ``chk`` / recompute and
  compare. The protect pass wraps producer->consumer map regions across
  BAR boundaries, so SRAM/DRAM data corruption in the guarded window is
  caught at the consumer instead of silently propagating.

All three check words meter ``check_bytes`` — a CSR-style counter on the
existing ``CounterBank`` that the timing walker models identically
(modeled == executed, as everywhere else).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

# --- operand value tables ---------------------------------------------------

REG_IN, REG_OUT, REG_F1, REG_F2 = 0, 1, 2, 3
REG_NAMES = {REG_IN: "IN", REG_OUT: "OUT", REG_F1: "F1", REG_F2: "F2"}

SPACE_DRAM, SPACE_SRAM = 0, 1
SPACE_NAMES = {SPACE_DRAM: "DRAM", SPACE_SRAM: "SRAM"}

WGT_EXP, WGT_DW, WGT_PROJ, WGT_CONV = 0, 1, 2, 3
MODE_WIN, MODE_VEC = 0, 1
STAGE_F1, STAGE_F2, STAGE_OUT = 0, 1, 2

KERNEL = 3  # the paper's depthwise kernel; fixed in the ISA

# --- opcodes & field layouts ------------------------------------------------

OPCODES: Dict[str, int] = {
    "HALT": 0x00,
    "CFG": 0x01,
    "SET_BASE": 0x02,
    "LD_WGT": 0x03,
    "LD_WIN": 0x04,
    "LD_VEC": 0x05,
    "LD_TILE": 0x06,
    "EXP_MAC": 0x07,
    "DW_MAC": 0x08,
    "PROJ_MAC": 0x09,
    "REQUANT": 0x0A,
    "RES_ADD": 0x0B,
    "ST_PX": 0x0C,
    "ST_VEC": 0x0D,
    "BAR": 0x0E,
    "CONV_MAC": 0x0F,
    "GAP_RST": 0x10,
    "GAP_ACC": 0x11,
    "GAP_FIN": 0x12,
    "CFG_PE": 0x13,
    "CFG_STRIP": 0x14,
    "CFG_CORE": 0x15,
    "CFG_DBUF": 0x16,
    "CFG_WINO": 0x17,
    "WINO_MAC": 0x18,
    "CHK_WGT": 0x19,
    "CHK_SAVE": 0x1A,
    "CHK_CMP": 0x1B,
}
MNEMONICS = {v: k for k, v in OPCODES.items()}

FIELD_SPECS: Dict[str, List[Tuple[str, int]]] = {
    "HALT": [],
    "CFG": [("cin", 10), ("cmid", 12), ("cout", 10), ("stride", 2),
            ("h", 10), ("w", 10)],
    "SET_BASE": [("reg", 2), ("space", 1), ("addr", 32)],
    "LD_WGT": [("which", 2), ("block", 10)],
    "LD_WIN": [("oy", 12), ("ox", 12)],
    "LD_VEC": [("reg", 2), ("y", 12), ("x", 12)],
    "LD_TILE": [("reg", 2), ("oy", 12), ("ox", 12)],
    "EXP_MAC": [("mode", 1)],
    "DW_MAC": [],
    "PROJ_MAC": [],
    "REQUANT": [("stage", 2)],
    "RES_ADD": [("oy", 12), ("ox", 12)],
    "ST_PX": [("oy", 12), ("ox", 12)],
    "ST_VEC": [("reg", 2), ("y", 12), ("x", 12)],
    "BAR": [("phase", 8)],
    "CONV_MAC": [],
    "GAP_RST": [],
    "GAP_ACC": [],
    "GAP_FIN": [("n", 12)],        # pooled pixel count (divisor)
    "CFG_PE": [("exp_pes", 8), ("dw_lanes", 8), ("proj_engines", 8)],
    "CFG_STRIP": [("rows", 8)],    # F1 rolling-strip depth; 0 = row-major
    "CFG_CORE": [("core", 8), ("n_cores", 8)],
    # ping/pong bases share the word, so they are 24-bit (16 MB) each
    "CFG_DBUF": [("reg", 2), ("space", 1), ("base0", 24), ("base1", 24)],
    # Winograd F(2x2,3x3) depthwise: 2x2 output tiles over a 4x4 F1 window
    "CFG_WINO": [("tiles_y", 12), ("tiles_x", 12), ("shared", 1)],
    "WINO_MAC": [("oy", 12), ("ox", 12)],
    # weight-stream checksum: additive uint8 sum mod 2^32, stamped at
    # protect time from the pristine params (see module docstring)
    "CHK_WGT": [("which", 2), ("block", 10), ("sum", 32)],
    # activation-region checksums through a 16-entry check-register file
    "CHK_SAVE": [("reg", 2), ("chk", 4)],
    "CHK_CMP": [("reg", 2), ("chk", 4)],
}

N_CHK_REGS = 16   # check-register file depth (CHK_SAVE/CHK_CMP.chk is 4 bits)


@dataclasses.dataclass(frozen=True)
class Instr:
    """One decoded instruction: mnemonic + named operand fields."""

    op: str
    args: Tuple[int, ...] = ()

    def __post_init__(self):
        spec = FIELD_SPECS.get(self.op)
        if spec is None:
            raise ValueError(f"unknown opcode {self.op!r}")
        if len(self.args) != len(spec):
            raise ValueError(f"{self.op} expects {len(spec)} operands "
                             f"{[n for n, _ in spec]}, got {self.args}")
        for v, (name, bits) in zip(self.args, spec):
            if not 0 <= int(v) < (1 << bits):
                raise ValueError(
                    f"{self.op}.{name}={v} out of range for {bits} bits")


@dataclasses.dataclass
class Program:
    """An instruction stream plus host-side binding metadata.

    ``meta`` is *not* part of the architectural state: it records where the
    compiler placed the input/output maps (so a host can bind tensors) and
    which ``DSCBlockSpec``s the stream implements. The words alone fully
    determine execution once input/params are bound.
    """

    instrs: List[Instr]
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.instrs)


# --- binary assembler / disassembler ---------------------------------------


def assemble(instr: Instr) -> int:
    """Instr -> 64-bit word."""
    word = OPCODES[instr.op] << 56
    pos = 56
    for v, (_, bits) in zip(instr.args, FIELD_SPECS[instr.op]):
        pos -= bits
        word |= int(v) << pos
    return word


def disassemble(word: int) -> Instr:
    """64-bit word -> Instr. Raises on unknown opcodes."""
    word = int(word)
    opcode = (word >> 56) & 0xFF
    op = MNEMONICS.get(opcode)
    if op is None:
        raise ValueError(f"unknown opcode byte 0x{opcode:02x}")
    args = []
    pos = 56
    for _, bits in FIELD_SPECS[op]:
        pos -= bits
        args.append((word >> pos) & ((1 << bits) - 1))
    return Instr(op, tuple(args))


# --- word parity (reliability extension) ------------------------------------
#
# Bit 0 of every word is outside all field layouts (CFG, the widest spec,
# stops at bit 2), so it can carry an even-parity bit without perturbing
# the decoded instruction: ``disassemble`` only reads spec'd fields.


def parity_of(word: int) -> int:
    """Population-count parity (0 = even number of set bits)."""
    return bin(int(word)).count("1") & 1


def with_parity(word: int) -> int:
    """Set bit 0 so the whole 64-bit word has even parity.

    ``assemble`` never sets bit 0, so this is total over assembled words.
    """
    word = int(word)
    if word & 1:
        raise ValueError("bit 0 already set: word is not a bare "
                         "assembled instruction")
    return word | parity_of(word)


def parity_ok(word: int) -> bool:
    return parity_of(word) == 0


def bad_parity_indices(words: Sequence[int]) -> List[int]:
    """Indices of words failing the even-parity check (the ISA-level
    single-bit-fault detector; the executor raises ``FaultDetected`` on a
    non-empty result when the stream's meta arms parity)."""
    return [i for i, w in enumerate(words) if not parity_ok(int(w))]


def checksum32(arr) -> int:
    """The CHK words' checksum: additive uint8 byte sum mod 2^32.

    A single bit flip in any byte moves the sum by exactly ±2^k (mod
    2^32, k < 8), which is never 0, so single-bit detection is exact —
    the property the campaign gate in ``benchmarks/bench_faults.py``
    relies on.
    """
    a = np.ascontiguousarray(np.asarray(arr), dtype=np.int8).reshape(-1)
    return int(a.view(np.uint8).sum(dtype=np.uint64) & np.uint64(0xFFFFFFFF))


def encode_program(program: Program) -> np.ndarray:
    """Program -> uint64 word array (the 'binary').

    When ``program.meta["parity"]`` is set, every word is stamped with an
    even-parity bit in bit 0 (see module docstring); unprotected programs
    encode byte-identically to earlier revisions.
    """
    words = [assemble(i) for i in program.instrs]
    if program.meta.get("parity"):
        words = [with_parity(w) for w in words]
    return np.asarray(words, dtype=np.uint64)


def decode_words(words: Sequence[int]) -> List[Instr]:
    return [disassemble(int(w)) for w in words]


# --- text assembler ----------------------------------------------------------


def instr_to_asm(instr: Instr) -> str:
    if not instr.args:
        return instr.op
    return f"{instr.op} " + ", ".join(str(int(v)) for v in instr.args)


def asm_to_instr(line: str) -> Instr:
    head, _, rest = line.strip().partition(" ")
    args = tuple(int(tok) for tok in rest.replace(",", " ").split()) \
        if rest.strip() else ()
    return Instr(head, args)


def program_to_asm(program: Program) -> str:
    return "\n".join(instr_to_asm(i) for i in program.instrs) + "\n"


def program_from_asm(text: str) -> Program:
    instrs = []
    for line in text.splitlines():
        line = line.split(";", 1)[0].strip()   # ';' starts a comment
        if line:
            instrs.append(asm_to_instr(line))
    return Program(instrs)
