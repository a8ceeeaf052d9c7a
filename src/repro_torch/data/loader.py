"""Host-side prefetching loader, as the reference has it.

A background thread makes the batches of consecutive steps while the device
computes the previous one — the standard straggler-avoidance pattern for
host-bound input pipelines. The generator is a pure function of the step
(``SyntheticCTR.batch``), so a restarted job reproduces the stream.
"""
from __future__ import annotations

import queue
import threading


class Prefetcher:
    def __init__(self, batch_fn, start_step: int = 0, depth: int = 2):
        """batch_fn: step -> batch dict (host numpy); at most ``depth``
        batches wait in the queue."""
        self.batch_fn = batch_fn
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.batch_fn(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        """Stop the thread, drop what waits in the queue and join."""
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
