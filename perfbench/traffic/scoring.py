"""What the two scoring drivers share: the engine over the program's packed
table built from the benchmark's served model, the host pool that requests
are slices of, the window's counters from the engine's own statistics, the
record of each dispatch's rows under the profiler (for the lookup's
roofline), the comparison of sampled answers with the reference, the
faults a scoring cell can have and the control's readings.
"""
from __future__ import annotations

import gc
import sys

import numpy as np
import torch

from perfbench.lib import bounds

# the faults a scoring cell can have (files of ``perfbench/faults``)
FAULTS = ("scatter_altered", "scatter_half_rows")
# the parameters both drivers share at a CPU test's size
TINY = {"pool_rows": 20_000, "buckets": {"serve_p99": 64, "serve_bulk": 2048}}


def setup(run):
    """(reference model, engine, host pool of per-field ids). The master
    table is freed once the program has packed it: the reference makes it
    again from the seed after the window."""
    p, dev = run.params, run.device
    ref = run.reference.Model(run.cfg, dev)
    served = ref.served(run.seed)
    engine = run.model.engine(ref, served, p, dev)
    del served
    pool = ref.request_pool(run.seed, p["pool_rows"]).cpu().numpy()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # each bucket's first dispatch (its pinned staging is made then)
    smallest = min(p["buckets"].values())
    for rows in sorted({smallest, smallest + 1}):
        engine.score(pool[:rows])
    return ref, engine, pool


def counters(engine) -> dict:
    """The engine's cumulative valid and padded rows, dispatches and batch
    assembly milliseconds, summed over its cells and requests."""
    occ = engine.stats.occupancy()
    cells = engine.summary()
    req = engine.request_summary().get("score")
    return {"valid": sum(c["valid_rows"] for c in occ.values()),
            "padded": sum(c["padded_rows"] for c in occ.values()),
            "dispatches": sum(c["count"] for c in cells.values()),
            "assembly_ms": (0.0 if req is None else
                            req["assembly"]["mean_ms"] * req["count"])}


def delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


class DispatchRecord:
    """While entered, every score cell's staged rows (the valid rows of
    each dispatch) and the cell's capacity are recorded."""

    def __init__(self, engine):
        self.engine = engine
        self.dispatches: list = []

    def __enter__(self):
        self._undo = []
        for reg in self.engine.registered_cells().values():
            if reg.celldef.kind != "score":
                continue
            cell, cap = reg.cell, reg.celldef.batch
            orig = cell.stage

            def stage(rows, _orig=orig, _cap=cap):
                self.dispatches.append((rows.copy(), _cap))
                return _orig(rows)
            cell.stage = stage
            self._undo.append(cell)
        return self

    def __exit__(self, *exc):
        for cell in self._undo:
            del cell.stage
        self._undo, self.engine = [], None


def lookup_bytes(ref, served, dispatches: list) -> int:
    """The bytes one lookup of each recorded dispatch must move: its
    padded rows' ids (padding is id 0 of every field), their distinct rows
    at their widths."""
    _, _, widx = served
    cfg, total = ref.cfg, 0
    d, bits = cfg["d_embed"], tuple(cfg["bits"])
    for rows, cap in dispatches:
        gids = torch.from_numpy(rows).to(ref.device).long() + ref.offsets
        gids = gids.reshape(-1)
        if rows.shape[0] < cap:
            gids = torch.cat([gids, ref.offsets])
        distinct = torch.unique(gids)
        counts = torch.bincount(widx[distinct].long(),
                                minlength=len(bits)).tolist()
        kept, words = bounds.packed_rows(counts, d, bits)
        total += bounds.lookup_bytes(cap * rows.shape[1], d, len(bits),
                                     distinct.numel(), kept, words)
    return total


def score_gap(ref, served, sample: list) -> float:
    """The widest gap of a sampled answer's score from the reference's,
    over the root mean square of the scores' scales (each the size of the
    terms its logit sums: a score's own size can cancel to near 0)."""
    dev = ref.device
    got, want, scale = [], [], []
    for ids, answer in sample:
        logits, s = ref.logits(served, torch.from_numpy(ids).to(dev))
        want.append(logits.double().cpu())
        scale.append(s.double().cpu())
        got.append(torch.from_numpy(np.asarray(answer, np.float64)))
    got, want, scale = torch.cat(got), torch.cat(want), torch.cat(scale)
    rms = float(scale.square().mean().sqrt())
    gap = float((got - want).abs().max()) / rms
    print(f"{len(sample)} answers ({got.numel()} scores) against the "
          f"reference: widest gap {gap:.3e} of the scores' scale (RMS "
          f"{rms:.4f})", file=sys.stderr)
    return gap


def control(run, seed: int, requests: list) -> dict:
    """The control's readings over ``requests`` (the id arrays a run of the
    cell checks): the plain reference in the program's place, its float32
    products in TF32, against the float32 reference."""
    ref = run.reference.Model(run.cfg, run.device)
    served = ref.served(seed)
    sample = [(ids, ref.logits(served, torch.from_numpy(ids).to(ref.device),
                               tf32=True)[0].cpu().numpy())
              for ids in requests]
    return {"score_gap": score_gap(ref, served, sample)}


def peak_bytes(dev) -> int:
    return torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0


def finish(run, ref, sample: list, dispatches: list) -> tuple:
    """Once the window has closed, the peak read and the engine dropped by
    the caller: the program's memory freed, the reference made again from
    the seed; (score gap, bytes of the recorded dispatches' lookups)."""
    dev = run.device
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    served = ref.served(run.seed)
    nbytes = lookup_bytes(ref, served, dispatches) if dispatches else 0
    gap = score_gap(ref, served, sample) if sample else float("nan")
    return gap, nbytes
