"""Request-level serving simulator over the CFU model (`cfu.serve`).

The CFU stack below stops at the device: single frames or lockstep
batches through ``executor.run_multistream``, priced by
``timing.analyze``. Deployment
questions — what latency does a user see at 150 QPS? what is the max
sustainable load under a 30 ms SLO? does batching help or hurt here? —
live one level up, at the REQUEST level. This package answers them with
a seeded discrete-event simulation whose service times come from the
calibrated cycle model and whose honesty is anchored by periodically
executing sampled dispatched batches bit-exactly through the golden
executor (cf. the deployment-level latency/throughput evaluations of
Daghero et al., arXiv:2406.12478, and Bai et al., arXiv:1809.01536).

Layers (each its own module):

* ``events``    — the discrete-event core: a deterministic event queue
  (cycle-stamped, stable tie-break) and the event log.
* ``arrivals``  — seeded arrival processes: Poisson, bursty on/off, and
  JSON trace replay.
* ``service``   — the device under test: a compiled CFU program (single
  stream or multi-core pipeline) wrapped with its batch-cost model
  (``timing.BatchCostModel`` / ``MultiStreamCostModel``) into a
  pipelined server (entry interval + group latency per batch size).
* ``policies``  — pluggable dynamic-batching policies (immediate,
  fixed-size-with-timeout, adaptive window) in a registry.
* ``dispatcher``— the simulator: arrivals -> queue -> policy -> device,
  with differential spot checks of sampled dispatched batches.
* ``metrics``   — p50/p95/p99 latency, throughput, per-core
  utilization, queue-depth traces, energy/frame.
* ``check``     — the golden-executor spot checker (bit-exact vs
  ``forward_batch`` + frame-accounting assertions); the one module that
  touches the device: its fast-path checks and its reference inference
  launch the DSC kernel on a card.
* ``planner``   — capacity planning: sweep arrival rate x policy x
  device config for max sustainable QPS under a latency SLO.
* ``report``    — render planner/simulation JSON as tables.

Entry point: ``python -m repro_torch.launch.serve_cfu`` (see its
docstring). Everything but ``check`` is host code (numpy, Python floats)
carried over from ``repro.cfu.serve`` expression for expression: event
logs, summaries and planner rows equal the reference's. The modeled
cycles, QPS and latencies are the simulated accelerator's at its clock,
not the card's.
"""

from repro_torch.cfu.serve.arrivals import ARRIVALS, make_arrivals
from repro_torch.cfu.serve.check import DifferentialSpotCheck
from repro_torch.cfu.serve.dispatcher import ServingSimulator, SimResult
from repro_torch.cfu.serve.events import Event, EventQueue
from repro_torch.cfu.serve.metrics import LATENCY_COMPONENTS, MetricsCollector
from repro_torch.cfu.serve.planner import max_sustainable_qps, plan_capacity
from repro_torch.cfu.serve.policies import (POLICIES, AdaptivePolicy,
                                      ImmediatePolicy, Policy,
                                      TimeoutPolicy, make_policy)
from repro_torch.cfu.serve.service import ServiceModel

__all__ = [
    "ARRIVALS", "make_arrivals", "DifferentialSpotCheck",
    "ServingSimulator", "SimResult", "Event", "EventQueue",
    "LATENCY_COMPONENTS", "MetricsCollector",
    "max_sustainable_qps", "plan_capacity",
    "POLICIES", "AdaptivePolicy", "ImmediatePolicy", "Policy",
    "TimeoutPolicy", "make_policy", "ServiceModel",
]
