"""Packed-table serving: the request lifecycle of the paper's §4 deployment
path, composable bottom-up.

  ``cache``     — CellCache: capture-once memo of serving executables keyed
                  by (arch, shape, device, bound tensors, mesh signature):
                  a CUDA graph on the card, the eager step on the CPU (and
                  on the card for a sharded cell on a multi-rank mesh).
  ``batcher``   — RequestBatcher: buckets arbitrary request sizes onto the
                  registered cell shapes; ``pack`` coalesces many requests
                  into shared chunks whose ``Span``s scatter outputs back.
  ``queue``     — AdmissionQueue: the bounded multi-lane arrival edge —
                  priority lanes with EDF order, per-tenant quotas,
                  watermark and deadline shedding, per-kind/per-tenant
                  counters.
  ``scheduler`` — Scheduler: drains the queue into coalesced cell
                  dispatches (with an optional max-wait window) and
                  isolates dispatch faults to the requests of the failed
                  chunk; ``DecodeSession`` runs continuous-batching LM
                  decode over a slot-pooled persistent KV cache.
  ``clock``     — ManualClock / TickClock: injectable time sources for
                  deterministic lifecycle tests and open-loop replay.
  ``engine``    — Engine: ``submit``/``poll``/``drain`` lifecycle with
                  ``score`` / ``retrieve`` / ``decode`` as synchronous
                  wrappers and ``submit_decode`` for generation; Figure-5 per-cell
                  latency split and per-request queue / assembly / compute
                  breakdown.
  ``repack``    — RepackPlanner / TableSwapper / PressureAdapter:
                  serving-time precision adaptation, swapped in place with
                  zero recompiles, driven by the tiered stores' counters.

The tiered lane serves from ``repro_torch.cache.TieredTableStore``
(``Engine.register_tiered_model``/``score_tiered``/``attach_tier_policy``);
the retrieve lane serves two-tower retrieval (``two_tower_retrieval_cell``,
``Engine.retrieve``); the decode lanes serve the LM (``lm_decode_cell``,
``lm_decode_slotted_cell``, ``Engine.decode``/``submit_decode``).

``Engine(mesh=)`` serves on a mesh of ``repro_torch.dist`` (default: the
host mesh, 1×1 in one process): under ``torch.distributed.run`` every rank
runs an engine over the same requests, the score and tiered cells'
gathers go through the sharded lookups (``shard_lookup``, with
``lookup_comms`` psum or a2a) and every rank gets the one-device scores,
bit for bit. A sharded cell on a mesh of more than one rank runs eager,
not as a CUDA graph. ``ServeCellDef.abstract_signature`` and the declared
specs feed the static checker (``repro_torch.analysis``).
"""
from repro_torch.serve.batcher import Chunk, RequestBatcher, Span
from repro_torch.serve.cache import (CellCache, CellKey, CompiledCell,
                                     device_signature, mesh_signature)
from repro_torch.serve.cells import (ServeCellDef, baseline_score_cell,
                                     lm_decode_cell, lm_decode_slotted_cell,
                                     packed_lookup_cell, packed_score_cell,
                                     packed_score_step, tiered_score_cell,
                                     two_tower_retrieval_cell)
from repro_torch.serve.clock import ManualClock, TickClock
from repro_torch.serve.engine import Engine
from repro_torch.serve.queue import (AdmissionQueue, Request,
                                     RequestFailedError, TenantQuota)
from repro_torch.serve.repack import (PressureAdapter, RepackPlan,
                                      RepackPlanner, TableSwapper,
                                      headroom_capacities,
                                      subtable_capacities)
from repro_torch.serve.scheduler import DecodeSession, Scheduler
from repro_torch.serve.stats import LatencyStats, RequestStats

__all__ = [
    "CellCache", "CellKey", "CompiledCell", "device_signature",
    "mesh_signature",
    "Chunk", "Span", "RequestBatcher", "LatencyStats", "RequestStats",
    "AdmissionQueue", "Request", "TenantQuota", "RequestFailedError",
    "ManualClock", "TickClock", "Scheduler", "DecodeSession",
    "ServeCellDef", "baseline_score_cell", "packed_score_cell",
    "packed_score_step", "packed_lookup_cell", "tiered_score_cell",
    "two_tower_retrieval_cell", "lm_decode_cell", "lm_decode_slotted_cell",
    "Engine", "RepackPlan", "RepackPlanner", "TableSwapper",
    "PressureAdapter",
    "headroom_capacities", "subtable_capacities",
]
