"""Instruction-level simulator of the paper's CFU (Custom Function Unit).

The paper's headline numbers — 59.3x over software RISC-V execution,
up to 87% data-movement reduction, and the zero-buffer pipeline — are
properties of *hardware* executing a dataflow, not of the math. ``core.dsc``
models the math (bit-exact int8 blocks) and ``core.traffic`` the analytic
byte counts; this package closes the gap with a second, independently
verifiable execution backend: a compact custom ISA, a compiler from block
specs to instruction streams, a bit-exact golden executor, and a
cycle/energy timing model. Every future scaling PR (multi-PE arrays,
batched simulation, new schedules) targets this ISA.

Architecture of the simulated machine
-------------------------------------
The CFU sits next to a scalar RISC-V core (which runs the stem/head of the
network) and owns:

* a 3x3xC input **window register** file with a validity mask (the
  hardware's on-the-fly padding: out-of-bounds taps never touch memory and
  read back as the quantization zero-point, paper Fig. 13b);
* an **F1 tile register** (3x3xM int8) and an **F2 vector register**
  (M int8) — the *only* intermediate state of the fused pipeline, which is
  the zero-buffer property;
* int32 accumulators and a requantize unit (TFLite fixed-point semantics,
  shared constants with ``core.quant``);
* two memory ports: **DRAM** (off-chip) and **SRAM** (on-chip scratch),
  plus a weight streamer.

Instruction set (see ``isa.py`` for encodings)
----------------------------------------------
======== ====================================================================
CFG       latch block shape (cin, cmid, cout, stride, h, w)
SET_BASE  bind a base register (IN/OUT/F1/F2) to a (space, address)
LD_WGT    stream one engine's weights (EXP/DW/PROJ) for a block index
LD_WIN    gather the 3x3xC input window for an output pixel (OTF padding)
LD_VEC    load one channel vector of a materialized map   (layer-by-layer)
LD_TILE   load a 3x3 window of a materialized map         (layer-by-layer)
EXP_MAC   expansion MACs: window (or vector) x W_exp -> int32 accumulator
DW_MAC    depthwise MACs: F1 tile x W_dw -> int32 accumulator
PROJ_MAC  projection MACs: F2 vector x W_proj -> int32 accumulator
REQUANT   requantize the pending accumulator into F1 / F2 / OUT domain
RES_ADD   quantized residual add (TFLite ADD) with the block input pixel
ST_PX     store the output pixel to the OUT map
ST_VEC    store the requantized vector to a materialized map (layer-by-layer)
BAR       stage barrier: drains the pipeline, resets the stream trackers
HALT      end of program
CONV_MAC  stem 3x3 standard conv over the loaded window -> int32 accumulator
GAP_RST   reset the global-average-pool int32 accumulator
GAP_ACC   add the last-loaded channel vector to the pooling accumulator
GAP_FIN   round(acc / n) -> int8 pooled vector on the projection port
CFG_PE    latch engine counts (expansion PEs, depthwise lanes, projection
          engines) — timing-only; the golden executor ignores it
CFG_STRIP put the F1 map into rolling-strip addressing (row mod depth) —
          the fused-rowtile schedule's circular line buffer; 0 = off
CFG_CORE  latch this stream's pipeline-stage slot (core i of n) — the
          multi-stream segment streams are self-describing
CFG_DBUF  bind a base register to a double-buffered boundary region
          (ping/pong base pair, resolved by the core's frame parity)
======== ====================================================================

Full-network simulation
-----------------------
``compiler.compile_vww_network`` lowers a COMPLETE MobileNetV2-VWW
inference (stem -> bottleneck chain -> head 1x1 -> GAP -> FC) into one
stream; ``network.vww_cfu_params`` binds a quantized
``models.mobilenetv2`` network to it. The executor carries a batch axis on
every memory space, so one stream drives N images in lockstep
(``run_words`` accepts (H, W, C) or (B, H, W, C)), bit-exact per image vs
``models.mobilenetv2.forward_int8(..., return_quantized=True)``.
``timing.PEConfig`` parameterizes the engine counts for
cycles-vs-PE-count sweeps (``benchmarks/bench_scaling.py``).

Pass-based compiler
-------------------
``compiler`` is a pass pipeline over the program IR of ``ir``:

    build IR -> schedule -> memory-plan -> instruction-select

Both entry points (bare DSC chain / full VWW network) build typed ops
(``Conv3x3``/``DSCBlock``/``Head1x1``/``GAP``/``FC``) and share one
lowering path. Scheduling is per block (uniform, per-block mapping, or
``"auto"`` — a cost-model pick via ``timing.analyze``); memory planning
is a liveness-driven first-fit allocator with buffer reuse that raises on
any live overlap (``ir.MemoryPlanError``). ``streams=N`` partitions the
op chain across N CFU cores sharing the DRAM port
(``compiler.MultiStreamProgram``; run with ``executor.run_multistream``,
time with ``timing.analyze_multistream``).

Heterogeneous frame pipeline
----------------------------
Multi-stream is a modeled heterogeneous frame-pipelined system:
``pe_per_core`` gives every core its own ``PEConfig`` (explicit list or
``compiler.AUTO_HETERO`` — a search over per-core allocations of the
homogeneous total engine budget), and the partitioner balances per-core
*time* under each core's own engine counts. Inter-core boundary maps are
explicitly double-buffered: ``ir.plan_memory(dbuf_values=...)`` allocates
ping/pong copies (DRAM scratch moves to per-segment arenas — program-
order liveness is unsound when every core re-executes its segment each
round), the streams bind them with CFG_DBUF, and
``executor.MultiStreamRunner`` ENFORCES the handoff (stale reads raise
``HandoffViolation``). Frame-level batching composes with the layer
pipeline (``run_multistream(batch=B)`` drives B frames per round in
lockstep); ``timing.analyze_multistream(batch=B)`` prices it — round
interval = max(slowest core + its handoffs, serialized DRAM port), with
per-phase pipeline fill amortized over the batch — and reports
steady-state ``frames_per_cycle`` and ``energy_per_frame_pj``
(``benchmarks/bench_scaling.py`` sweeps both and CI gates that an
auto-hetero 2-core split strictly beats the equal-budget homogeneous
one).

Schedules (``ir.CFUSchedule``, registry ``ir.SCHEDULES``)
---------------------------------------------------------
* ``LAYER_DRAM``    — layer-by-layer, F1/F2 materialized in DRAM (paper
  Eq. 1 baseline traffic).
* ``LAYER_SRAM``    — layer-by-layer, F1/F2 in on-chip SRAM (paper Eq. 2:
  needs a >= H*W*M-byte buffer).
* ``FUSED``         — the paper's fused pixel-wise dataflow: one output
  pixel to completion, intermediates only in the tile/vector registers.
* ``FUSED_ROWTILE`` — row-tile fusion over a rolling SRAM F1 strip
  (CFG_STRIP) with halo *reuse* across tiles (two rows at stride 1, one
  at stride 2): expansion runs exactly once per input row, DRAM traffic
  equals FUSED's exactly (``dsc_block_fused_rowtile``/Pallas granularity).

All four produce **bit-identical** int8 outputs, equal to
``core.dsc.dsc_block_reference`` (asserted with exact integer equality in
``tests/test_cfu.py``, the same discipline ``tests/test_dsc.py`` applies to
the JAX paths).

Paper-table mapping (``benchmarks/bench_cfu.py``)
-------------------------------------------------
* Table III(A) / Fig. 14 — ``timing.analyze`` cycles for the FUSED stream
  under v1/v2/v3 pipelining vs the calibrated software-v0 model
  (``core.fusion.modeled_cycles``); reproduces the 27.4x/46.3x/59.3x
  progression on the 3rd bottleneck layer.
* Table V — energy from MAC counts + per-level byte prices (shared
  constants with ``benchmarks/bench_energy.py``).
* Table VI — DRAM/SRAM bytes measured from the instruction streams with
  line-buffered (unique-byte) read accounting; matches ``core.traffic``'s
  analytic Eq. 1/2 counts *exactly* and reproduces the up-to-87% reduction.
"""

from repro_torch.cfu.isa import (Instr, Program, assemble, disassemble,
                                 encode_program, decode_words, program_to_asm,
                                 program_from_asm)
from repro_torch.cfu.ir import (CFUSchedule, Layout, MemoryPlanError, SCHEDULES,
                                build_chain_ir, build_vww_ir, plan_memory)
from repro_torch.cfu.compiler import (AUTO_HETERO, AUTO_SCHEDULE,
                                      MultiStreamProgram, assign_schedules,
                                      auto_schedule, compile_block,
                                      compile_network, compile_vww_network,
                                      hetero_pe_candidates, schedule_names,
                                      select_instructions, split_pe_budget)
from repro_torch.cfu.executor import (HandoffViolation, MultiStreamRunner,
                                      run_multistream, run_program, run_words)
from repro_torch.cfu.network import (CFUFCParams, CFUHeadParams, CFUStemParams,
                                     vww_cfu_params)
from repro_torch.cfu.timing import (BatchCostModel, MultiStreamCostModel,
                                    MultiStreamReport, PEConfig, TimingReport,
                                    analyze, analyze_multistream)
from repro_torch.cfu.trace import (NULL_TRACER, CounterBank, NullTracer, Tracer)

__all__ = [
    "Instr", "Program", "assemble", "disassemble", "encode_program",
    "decode_words", "program_to_asm", "program_from_asm",
    "CFUSchedule", "SCHEDULES", "AUTO_SCHEDULE", "AUTO_HETERO", "Layout",
    "MemoryPlanError", "build_chain_ir", "build_vww_ir", "plan_memory",
    "assign_schedules", "auto_schedule", "schedule_names",
    "select_instructions", "compile_block", "compile_network",
    "compile_vww_network", "split_pe_budget", "hetero_pe_candidates",
    "MultiStreamProgram", "MultiStreamRunner", "HandoffViolation",
    "run_program", "run_words", "run_multistream",
    "TimingReport", "MultiStreamReport", "analyze", "analyze_multistream",
    "PEConfig", "CFUStemParams", "CFUHeadParams", "CFUFCParams",
    "vww_cfu_params",
    "BatchCostModel", "MultiStreamCostModel",
    "Tracer", "NullTracer", "NULL_TRACER", "CounterBank",
]
