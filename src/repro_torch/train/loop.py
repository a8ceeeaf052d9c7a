"""Generic fault-tolerant training loop.

Works with every model through a uniform loss signature:

    loss_fn(params, buffers, state, batch, *, step) -> (loss, (new_state, metric))

It keeps the reference loop's features: the global-norm clip
(``clip_norm``), the NaN/inf guard (a step whose gradient norm or loss is
not finite leaves the parameters and the whole optimizer state, its step
included, as they were; the BatchNorm state still takes its new value, as in
the reference), checkpoints every ``ckpt_every`` steps (atomic, keep-k,
async) and ``restore()`` on start, the compressor's post-update hook, int8
gradient compression with error feedback (``grad_compression``), data keyed
by step, and prefetch (``run(prefetch=...)``).

On a mesh of more than one rank (``Trainer(mesh=...)``, every rank running
the same loop over the same batches, SPMD) the loss and gradient come from
``repro_torch.dist.shard.sharded_value_and_grad``: each rank takes its
block of the batch, the ``params["embedding"]`` leaves whose rows divide
the ``table_rows_axes`` are held as this rank's row shards (the carry, the
optimizer's moments and the checkpoints hold the shards; ``params`` gathers
the whole tree), gathered in the forward, their gradients reduce-scattered
back; every other leaf's gradient is averaged over the mesh. The clip's
norm is the global one — the squared norms of the shards summed over the
row axes once (``sharded_clip_scale``) — so every rank takes the same
scale and the NaN guard's verdict agrees everywhere. Each rank checkpoints
its own carry under ``ckpt_dir/rank<r>``.

The parameters, the optimizer's state and the error-feedback residuals are
updated in place, as the reference's jitted step updates its donated carry:
after the backward pass, one pass per leaf applies the clip's scale and the
optimizer (``optimizer.update_``), so no second tree is alive at any time. A
restore copies the checkpoint into the same tensors. The guard stays on the
device and exact: the update reads the step's ``ok`` flag from device memory
and writes nothing where it is false, so no step waits for the host. Nothing
in a step copies from the host but its batch, so the host makes the next
batch while the device runs this step. A tree handed to the trainer is the
tree it trains: whoever needs its starting values keeps a copy (the pipeline
takes host snapshots, as the reference does).
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.cache.prefetch import PrefetchPipeline
from repro_torch.dist.shard import (active_mesh, gather_table_leaves,
                                    shard_table_leaves, sharded_clip_scale,
                                    sharded_value_and_grad, table_shard_flags)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.compression import make_error_feedback_transform
from repro_torch.train.optimizer import clip_scale
from repro_torch.train.tree import leaves, tree_map, unflatten


def _detached(tree):
    return tree_map(lambda x: x.detach() if torch.is_tensor(x) else x, tree)


def _restorable(carry):
    """The carry without its None entries (npz cannot store them)."""
    return {k: v for k, v in carry.items() if v is not None}


def _on_device(v, device) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.to(device)
    return torch.from_numpy(np.asarray(v)).to(device)


class Trainer:
    def __init__(self, loss_fn: Callable, params, buffers, state, optimizer, *,
                 ckpt_dir: str | None = None, ckpt_every: int = 200,
                 ckpt_keep: int = 3, clip_norm: float = 10.0,
                 post_update: Callable | None = None,
                 grad_compression: bool = False, mesh=None,
                 table_rows_axes=("model",)):
        self.loss_fn = loss_fn
        self.buffers = buffers
        self.optimizer = optimizer
        # loss+grad: plain on one device; on a mesh of more than one rank
        # the batch is data-parallel and the embedding rows are sharded
        # over `table_rows_axes` (repro_torch.dist.shard)
        self.mesh = active_mesh(mesh)
        self.table_rows_axes = tuple(table_rows_axes)
        self._flags = self._vag = None
        if self.mesh is not None:
            self._flags = table_shard_flags(params, self.mesh,
                                            self.table_rows_axes)
            params = shard_table_leaves(params, self.mesh,
                                        self.table_rows_axes)
            self._vag = sharded_value_and_grad(
                loss_fn, self.mesh, rows_axes=self.table_rows_axes,
                flags=self._flags)
            if ckpt_dir is not None:
                ckpt_dir = f"{ckpt_dir}/rank{self.mesh.rank}"
        self.ckpt_dir, self.ckpt_every, self.ckpt_keep = ckpt_dir, ckpt_every, ckpt_keep
        self.clip_norm = clip_norm
        self.post_update = post_update
        self.grad_compression = grad_compression
        self.step = 0
        self.device = leaves(params)[0].device
        ef_init, self._ef_apply = make_error_feedback_transform()
        self.carry = {"params": params, "state": state,
                      "opt": optimizer.init(params),
                      "ef": ef_init(params) if grad_compression else None}
        self.history: list[dict] = []

    def train_step(self, batch: dict, step: int) -> dict:
        """One update on ``batch`` (tensors on the trainer's device). Returns
        {"loss", "metric", "grad_norm", "skipped"} as device tensors."""
        params, state, opt_state = (self.carry["params"], self.carry["state"],
                                    self.carry["opt"])
        step_t = torch.full((), step, dtype=torch.int32, device=self.device)
        if self._vag is not None:
            (loss, (new_state, metric)), grads = self._vag(
                params, self.buffers, state, batch, step=step_t)
            scale, gnorm = sharded_clip_scale(grads, self._flags, self.mesh,
                                              self.table_rows_axes,
                                              self.clip_norm)
        else:
            flat = [p.detach().requires_grad_(True) for p in leaves(params)]
            live = unflatten(params, flat)
            with torch.enable_grad():
                loss, (new_state, metric) = self.loss_fn(
                    live, self.buffers, state, batch, step=step_t)
                grads = list(torch.autograd.grad(loss, flat))
            del flat, live
            scale, gnorm = clip_scale(grads, self.clip_norm)
        loss, metric = loss.detach(), metric.detach()
        # NaN guard: skip the whole update on a non-finite norm or loss
        ok = torch.isfinite(gnorm) & torch.isfinite(loss)
        if self.grad_compression:
            # the reference's order: the clip, then the error feedback,
            # whose residuals are carried whether or not the guard skips
            clipped = [g.mul_(scale) for g in grads]
            ef = self.carry["ef"]
            grads, new_ef = self._ef_apply(clipped, leaves(ef))
            del clipped
            for e, n in zip(leaves(ef), new_ef):
                e.copy_(n)
            del new_ef
            scale = torch.ones((), dtype=torch.float32, device=self.device)
        self.optimizer.update_(params, unflatten(params, list(grads)),
                               opt_state, scale, ok)
        del grads
        self.carry["state"] = _detached(new_state)
        return {"loss": loss, "metric": metric, "grad_norm": gnorm,
                "skipped": ~ok}

    # -- fault tolerance ----------------------------------------------------
    def restore(self) -> bool:
        """Load the latest checkpoint of ``ckpt_dir`` into the carry, in
        place (every leaf keeps its tensor), and its step. Returns whether
        there was one."""
        if self.ckpt_dir is None:
            return False
        tree, _ = ckpt.restore(self.ckpt_dir, {"carry": _restorable(self.carry),
                                               "step": 0})
        if tree is None:
            return False
        restored = tree["carry"]
        for key in ("params", "opt", "ef"):
            if self.carry.get(key) is not None:
                for x, y in zip(leaves(self.carry[key]), leaves(restored[key])):
                    x.copy_(y)
        self.carry["state"] = restored["state"]
        self.step = int(tree["step"])
        return True

    def save(self, blocking: bool = False):
        if self.ckpt_dir is None:
            return
        payload = {"carry": _restorable(self.carry), "step": self.step}
        if blocking:
            ckpt.save(self.ckpt_dir, self.step, payload, keep=self.ckpt_keep)
        else:
            ckpt.save_async(self.ckpt_dir, self.step, payload, keep=self.ckpt_keep)

    # -- main loop ------------------------------------------------------------
    def run(self, data_fn: Callable, n_steps: int, *, log_every: int = 100,
            log_fn=print, prefetch=False) -> dict:
        """Run up to ``n_steps``. Each step's outputs are kept on the device
        and read once, at the end, into ``self.history`` (one dict of
        floats per step, with the host time spent getting its batch), so
        the host enqueues the next step while the device runs this one —
        except at ``log_every``, where the log line reads them.

        ``prefetch`` makes and stages batches ahead of the step that reads
        them (``repro_torch.cache.PrefetchPipeline``): True for a default
        pipeline (closed at the end), or a pre-built one, which must stage
        on the trainer's device. Same bytes, same order: the losses are
        those of the synchronous loop."""
        owned = None
        if prefetch:
            if isinstance(prefetch, PrefetchPipeline):
                if prefetch.device != self.device:
                    raise ValueError(
                        f"the pipeline stages on {prefetch.device}, the "
                        f"trainer runs on {self.device}: build it with "
                        f"device={str(self.device)!r}")
                data_fn = prefetch
            else:
                data_fn = owned = PrefetchPipeline(data_fn, device=self.device)
        t0 = time.perf_counter()
        start = self.step
        outs, data_ms = [], []
        last = {}
        try:
            while self.step < n_steps:
                t_data = time.perf_counter()
                batch = data_fn(self.step)
                data_ms.append((time.perf_counter() - t_data) * 1e3)
                batch = {k: _on_device(v, self.device) for k, v in batch.items()}
                out = self.train_step(batch, self.step)
                del batch
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
                if self.ckpt_dir and self.step % self.ckpt_every == 0:
                    self.save()
        finally:
            if owned is not None:
                owned.close()
        if self.ckpt_dir:
            self.save(blocking=True)
        for i, (out, ms) in enumerate(zip(outs, data_ms)):
            self.history.append({"step": start + i, "data_ms": ms,
                                 **{k: float(v) for k, v in out.items()}})
        return last

    @property
    def params(self):
        """The trained tree: the carry's own tensors, or on a mesh the
        whole tree, its row shards all-gathered (a collective: every rank
        reads it)."""
        if self.mesh is None:
            return self.carry["params"]
        return gather_table_leaves(self.carry["params"], self._flags,
                                   self.mesh, self.table_rows_axes)

    @property
    def state(self):
        return self.carry["state"]
