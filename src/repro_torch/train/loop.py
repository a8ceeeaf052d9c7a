"""Generic training loop.

Works with every model through a uniform loss signature:

    loss_fn(params, buffers, state, batch, *, step) -> (loss, (new_state, metric))

It keeps the reference loop's global-norm clip (at its default norm,
``CLIP_NORM``), its NaN/inf guard (a step whose gradient norm or loss is not
finite leaves the parameters and the whole optimizer state, Adam's step
included, as they were; the BatchNorm state still takes its new value, as in
the reference), the compressor's post-update hook, and data keyed by step.
Checkpoints, the device mesh, gradient compression and prefetch are not
ported yet.

The parameters, both Adam moments and Adam's step are updated in place, as
the reference's jitted step updates its donated carry: after the backward
pass, one pass per leaf applies the clip's scale, Adam and the weight decay
(``optimizer.update_``), so no second tree is alive at any time. The
guard stays on the device and exact: the pass reads the step's ``ok`` flag
from device memory and writes nothing where it is false, so no step waits
for the host. Nothing in a step copies from the host but its batch, so the
host makes the next batch while the device runs this step. A tree handed to
the trainer is the tree it trains: whoever needs its starting values keeps
a copy (the pipeline takes host snapshots, as the reference does).
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.train.optimizer import clip_scale
from repro_torch.train.tree import leaves, tree_map, unflatten

CLIP_NORM = 10.0   # the reference Trainer's default clip_norm


def _detached(tree):
    return tree_map(lambda x: x.detach() if torch.is_tensor(x) else x, tree)


class Trainer:
    def __init__(self, loss_fn: Callable, params, buffers, state, optimizer, *,
                 post_update: Callable | None = None):
        self.loss_fn = loss_fn
        self.buffers = buffers
        self.optimizer = optimizer
        self.post_update = post_update
        self.step = 0
        self.device = leaves(params)[0].device
        self.carry = {"params": params, "state": state,
                      "opt": optimizer.init(params)}
        self.history: list[dict] = []

    def train_step(self, batch: dict, step: int) -> dict:
        """One update on ``batch`` (tensors on the trainer's device). Returns
        {"loss", "metric", "grad_norm", "skipped"} as device tensors."""
        params, state, opt_state = (self.carry["params"], self.carry["state"],
                                    self.carry["opt"])
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        live = unflatten(params, flat)
        step_t = torch.full((), step, dtype=torch.int32, device=self.device)
        with torch.enable_grad():
            loss, (new_state, metric) = self.loss_fn(live, self.buffers, state,
                                                     batch, step=step_t)
            grads = torch.autograd.grad(loss, flat)
        loss, metric = loss.detach(), metric.detach()
        del flat, live
        scale, gnorm = clip_scale(grads, CLIP_NORM)
        # NaN guard: skip the whole update on a non-finite norm or loss
        ok = torch.isfinite(gnorm) & torch.isfinite(loss)
        self.optimizer.update_(params, unflatten(params, list(grads)),
                               opt_state, scale, ok)
        del grads
        self.carry["state"] = _detached(new_state)
        return {"loss": loss, "metric": metric, "grad_norm": gnorm,
                "skipped": ~ok}

    def run(self, data_fn: Callable, n_steps: int, *, log_every: int = 100,
            log_fn=print) -> dict:
        """Run up to ``n_steps``. Each step's outputs are kept on the device
        and read once, at the end, into ``self.history`` (one dict of
        floats per step, with the host time spent making its batch), so
        the host enqueues the next step while the device runs this one —
        except at ``log_every``, where the log line reads them."""
        t0 = time.perf_counter()
        start = self.step
        outs, data_ms = [], []
        last = {}
        while self.step < n_steps:
            t_data = time.perf_counter()
            batch = data_fn(self.step)
            data_ms.append((time.perf_counter() - t_data) * 1e3)
            batch = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                     for k, v in batch.items()}
            out = self.train_step(batch, self.step)
            if self.post_update is not None:
                self.carry["params"] = self.post_update(self.carry["params"])
            outs.append(out)
            self.step += 1
            if log_every and self.step % log_every == 0:
                last = {k: float(v) for k, v in out.items()}
                log_fn(f"step {self.step} loss {last['loss']:.5f} "
                       f"gnorm {last['grad_norm']:.3f} "
                       f"({(time.perf_counter() - t0) / (self.step - start) * 1e3:.1f}"
                       f" ms/step)")
        for i, (out, ms) in enumerate(zip(outs, data_ms)):
            self.history.append({"step": start + i, "data_ms": ms,
                                 **{k: float(v) for k, v in out.items()}})
        return last

    @property
    def params(self):
        return self.carry["params"]

    @property
    def state(self):
        return self.carry["state"]
