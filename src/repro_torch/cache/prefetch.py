"""Async prefetch: make and stage the next steps' inputs while this step
computes.

PyTorch launches a step's kernels asynchronously, so the host is free while
the card works. The synchronous loop wastes that window: it makes batch
``s+1`` on the host and copies it to the card only after it has enqueued
step ``s``. ``PrefetchPipeline`` moves that work ahead: when the trainer
asks for batch ``s`` it receives a batch already on the card, and the
pipeline starts making steps ``s+1 .. s+depth`` at once, each on a worker
thread of its own (``data_fn`` is a pure function of the step;
``SyntheticCTR.batch`` spends its time in numpy calls that release the
interpreter lock). ``data.loader.Prefetcher``, the reference's one
background thread, makes consecutive steps one after another and so cannot
have ``depth`` batches in the making; the pipeline keeps its own pool. A
worker copies its batch into pinned host memory and from there to the card
on a side stream, and records an event; the step's stream waits on that
event, and each tensor is ``record_stream``-ed on it, so that no buffer is
reused while a copy or a step still reads it.

The pipeline changes *when* bytes move, never *which* bytes: a staged batch
is bit-identical to what the synchronous loop builds, so the losses match
step for step. Like every entry point of the port it stages on the card
unless the caller names another device; on the CPU a batch is staged by
``torch.from_numpy``.

With a ``TieredTableStore`` attached it also stages each batch's cold
embedding rows (``store.prefetch_cold``), exposed through ``take_cold``.
Those fills are routed on the caller's thread, in step order, never on the
workers: an attached tier policy's decayed scores depend on the order of
its observations, and the reference stages them in step order. A call
therefore waits for the batches it has just asked for to route their
cold rows, so the counters and scores after N calls are the reference's.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device


class PrefetchPipeline:
    """Depth-``depth`` read-ahead wrapper around a ``data_fn(step) -> batch``.

    Drop-in for the Trainer's ``data_fn`` (``trainer.run(..., prefetch=True)``
    builds one): ``pipeline(step)`` returns the staged batch for ``step`` on
    ``device`` (the card unless another is named) and starts staging steps
    ``step+1 .. step+depth``; a jump (a restore) drops the stale
    read-ahead. ``close()`` stops the workers.

    ``store``/``ids_key``: optionally prefetch the batch's cold embedding
    rows from a ``TieredTableStore`` at the same time; ``offsets`` (per-field
    id offsets) globalizes the ids first, matching the model's lookup.
    ``take_cold(step)`` hands out the staged fill of ``step``.
    """

    def __init__(self, data_fn: Callable, *, depth: int = 1, device=None,
                 store=None, ids_key: str = "ids", offsets=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.store = store
        self.ids_key = ids_key
        self.offsets = None if offsets is None else np.asarray(offsets)
        self._cold: dict = {}        # step -> ColdPrefetch
        self._to_route: list = []    # steps submitted, in order, not routed
        self.data_fn = data_fn
        self.depth = depth
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._side = torch.cuda.Stream(self.device) if self._cuda else None
        self._pool = ThreadPoolExecutor(max_workers=depth,
                                        thread_name_prefix="prefetch")
        self._staged: dict = {}      # step -> Future of (batch, event, ids)

    def _stage(self, step: int):
        raw = self.data_fn(step)
        ids = raw.get(self.ids_key) if self.store is not None else None
        if not self._cuda:
            return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                    for k, v in raw.items()}, None, ids
        staged = {}
        with torch.cuda.stream(self._side):
            for k, v in raw.items():
                host = torch.from_numpy(np.ascontiguousarray(v))
                pinned = torch.empty(host.shape, dtype=host.dtype,
                                     pin_memory=True)
                pinned.copy_(host)
                staged[k] = pinned.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._side)
        return staged, event, ids

    def _submit(self, step: int):
        self._staged[step] = self._pool.submit(self._stage, step)
        if self.store is not None:
            self._to_route.append((step, self._staged[step]))

    def _route(self):
        """Stage the cold rows of every step submitted since the last call,
        in step order, on this thread."""
        for step, future in self._to_route:
            ids = future.result()[2]
            if ids is None:
                continue
            ids = np.asarray(ids)
            if self.offsets is not None:
                ids = ids + self.offsets[None, :]
            self._cold[step] = self.store.prefetch_cold(ids)
        self._to_route.clear()

    def __call__(self, step: int) -> dict:
        if step not in self._staged:            # cold start / restart
            self._submit(step)
        for ahead in range(step + 1, step + 1 + self.depth):
            if ahead not in self._staged:
                self._submit(ahead)
        self._route()
        batch, event, _ = self._staged.pop(step).result()
        # drop stale read-ahead (e.g. after a checkpoint-restore jump); cold
        # fills are evicted independently — the served step's fill survives
        # until the caller's take_cold or the next call, never longer
        for s in [s for s in self._staged if s < step]:
            self._staged.pop(s).cancel()
        for s in [s for s in self._cold if s < step]:
            self._cold.pop(s)
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for x in batch.values():
                x.record_stream(stream)
        return batch

    def take_cold(self, step: int):
        """The staged ``ColdPrefetch`` of ``step`` (or None)."""
        return self._cold.pop(step, None)

    def close(self):
        """Cancel what has not started and wait for the workers."""
        for future in self._staged.values():
            future.cancel()
        self._staged.clear()
        self._to_route.clear()
        self._pool.shutdown(wait=True)
