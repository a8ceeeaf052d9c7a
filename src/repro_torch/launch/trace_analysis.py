"""Per-device FLOPs, bytes and collective bytes of an op walk.

The port's counterpart of the reference's ``launch/hlo_analysis.py``. The
reference compiles a cell SPMD and parses the partitioned HLO; the port
has no compiler between the step and the device — eager PyTorch runs each
aten op as its own kernel and each hand-written kernel as one launch — so
the artifact to analyse is the op walk of one rank's step
(``repro_torch.analysis.op_walk``), whose shapes are that rank's shapes,
so every total is per device:

  - flops:        2 · |out| · K for every matrix product (``mm``,
                  ``addmm``, ``bmm``, ``baddbmm``; ``linear`` and
                  ``matmul`` reach the walk as these) and convolution (K:
                  the weight's input channels a group times its window),
                  plus each kernel region's analytic FLOPs;
  - hbm_bytes:    operand plus output bytes of every op outside a region
                  (eager runs no fusion, so each aten op reads its operands
                  and writes its outputs; view ops and allocations move
                  none), plus each region's analytic bytes;
  - collectives:  per kind, the bytes each recorded collective leaves on a
                  device (the output-shard convention of the reference's
                  HLO accounting) and their count.

An eager walk runs every loop trip and only the branch taken, so the
reference's while-loop trip-count weighting, its ``cond_mode`` (which
branch of a ``lax.cond`` to charge) and ``normalize_cost`` (the shapes of
``compiled.cost_analysis()``) have no counterpart here: what the walk
counts is what ran.
"""
from __future__ import annotations

from collections import defaultdict

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")

# allocations: they launch no kernel and move no bytes
_NO_BYTES = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                       "new_empty_strided", "_local_scalar_dense",
                       "lift_fresh", "detach", "alias"})


def _prod(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _opname(name: str) -> str:
    parts = name.split(".")
    return parts[1] if len(parts) > 1 else name


def op_flops(item) -> int:
    """2 · |out| · K of one walked matrix product or convolution, else 0."""
    name = _opname(item.name)
    if not item.out_shapes:
        return 0
    out = _prod(item.out_shapes[0])
    ins = item.in_shapes
    if name in ("mm", "bmm") and ins:
        return 2 * out * int(ins[0][-1])
    if name in ("addmm", "baddbmm") and len(ins) >= 2:
        return 2 * out * int(ins[1][-1])
    if name in ("convolution", "_convolution", "conv1d", "conv2d",
                "conv3d") and len(ins) >= 2:
        return 2 * out * _prod(ins[1][1:])
    return 0


def analyze(walk) -> dict:
    """The reference's keys for one walked step: ``flops_per_device``,
    ``hbm_bytes_per_device`` and ``collectives_per_device`` (per kind
    ``{"bytes", "count"}``, plus ``total_bytes``); also the kernel
    regions' share (``region_flops``, ``region_bytes``) and counts."""
    flops = hbm = region_flops = region_bytes = 0
    coll = defaultdict(lambda: [0, 0])
    n_ops = n_regions = 0
    for item in walk.items:
        if item.kind == "op":
            n_ops += 1
            flops += op_flops(item)
            if not item.view and _opname(item.name) not in _NO_BYTES:
                hbm += item.in_bytes + item.out_bytes
        elif item.kind == "region":
            n_regions += 1
            region_flops += item.flops
            region_bytes += item.bytes
        else:
            coll[item.name][0] += item.bytes
            coll[item.name][1] += 1
    coll_out = {k: {"bytes": float(b), "count": c}
                for k, (b, c) in coll.items()}
    coll_out["total_bytes"] = float(sum(b for b, _ in coll.values()))
    return {
        "flops_per_device": float(flops + region_flops),
        "hbm_bytes_per_device": float(hbm + region_bytes),
        "collectives_per_device": coll_out,
        "region_flops": float(region_flops),
        "region_bytes": float(region_bytes),
        "n_ops": n_ops,
        "n_regions": n_regions,
    }
