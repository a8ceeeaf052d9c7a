"""The serving engine, synchronous subset: score requests over registered
cell shapes from a packed table.

A request of any size is planned onto the registered shapes (``serve_p99``,
``serve_bulk``) by ``RequestBatcher``, padded with id 0, run in eval mode on
the engine's device, and unpadded — the per-request plan that the
reference's request lifecycle reproduces bit for bit for a lone request.
Each dispatch is timed on the host clock up to a device synchronize, and the
lookup alone is timed at the same padded shape for the paper's Figure-5
lookup-vs-compute split. On the card the lookup is the CUDA ``mpe_lookup``
kernel.

The admission queue, scheduler, tenancy, repack, tiered cells and decode
are not part of this subset.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.inference import packed_lookup_fn
from repro_torch.device import full_float32, resolve_device
from repro_torch.serve.batcher import RequestBatcher
from repro_torch.serve.stats import LatencyStats


class ScoreCell(NamedTuple):
    """One registered score shape: ``step`` maps padded ids (rows, F) int32
    on the engine's device to logits (rows,); ``lookup`` is its lookup-only
    half, timed for the Figure-5 split (None when not requested)."""
    arch: str
    shape: str
    step: Callable
    lookup: Callable | None

    @property
    def name(self) -> str:
        return f"{self.arch}/{self.shape}"


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _on_device(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on_device(v, device) for v in tree]
    return tree


class Engine:
    """Front-end over registered score cells and the request batcher.

    Runs on the CUDA card unless ``device`` names another."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        full_float32(self.device)   # serving starts here
        self.stats = LatencyStats()
        self._score: dict[str, ScoreCell] = {}
        self._score_batcher = RequestBatcher()
        self._completed = 0

    def register_packed_model(self, arch, model, cfg, params, state, buffers,
                              *, shapes: dict[str, int],
                              lookup_split: bool = True):
        """Register one score cell per (shape name → row capacity) for a flat
        CTR model serving from a packed table. The model's tensors move to
        the engine's device once, here."""
        params, state, buffers = (_on_device(t, self.device)
                                  for t in (params, state, buffers))
        meta = {k: cfg.comp_cfg[k] for k in ("bits", "d", "n")}
        lookup = packed_lookup_fn(meta)
        offsets = buffers["offsets"]

        def step(ids):
            return model.apply(params, buffers, state, {"ids": ids}, cfg)[0]

        def lookup_step(ids):
            return lookup(params["embedding"], ids + offsets[None, :])

        for shape, rows in shapes.items():
            self._score[shape] = ScoreCell(arch, shape, step,
                                           lookup_step if lookup_split else None)
            self._score_batcher.register(shape, rows)

    def _timed_call(self, fn, x):
        t0 = time.perf_counter()
        out = fn(x)
        if self.device.type == "cuda":
            # deliberate timing barrier: wall-clock per dispatch is the product
            torch.cuda.synchronize(self.device)
        return out, (time.perf_counter() - t0) * 1e3

    def score(self, ids, *, return_logits: bool = False) -> np.ndarray:
        """Score an (n, F) id batch; any n — planned onto the registered cell
        shapes. Returns probabilities (or raw logits)."""
        ids = np.asarray(ids, np.int32)
        out = np.empty((ids.shape[0],), np.float32)
        with torch.inference_mode():
            for chunk, padded, _mask in self._score_batcher.split(ids):
                cell = self._score[chunk.bucket]
                x = torch.from_numpy(np.ascontiguousarray(padded)).to(self.device)
                y, total_ms = self._timed_call(cell.step, x)
                lookup_ms = None
                if cell.lookup is not None:
                    _, lookup_ms = self._timed_call(cell.lookup, x)
                self.stats.record(cell.name, total_ms, lookup_ms,
                                  valid_rows=chunk.n_valid,
                                  capacity_rows=chunk.rows)
                out[chunk.start:chunk.start + chunk.n_valid] = \
                    RequestBatcher.unpad(y, chunk.n_valid).cpu().numpy()
        self._completed += 1
        return out if return_logits else _sigmoid(out)

    def counters(self) -> dict:
        """Per-cell occupancy (valid rows / padded rows over every dispatch)
        and goodput — completed requests — by lane."""
        return {"occupancy": self.stats.occupancy(),
                "goodput": {"by_lane": {"score:p0": self._completed}}}
