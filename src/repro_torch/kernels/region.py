"""Kernel calls as opaque regions of an op walk, and the kernels' shape
rules on the meta device.

An op walk (``repro_torch.analysis.op_walk``) records every aten op a step
runs. A kernel wrapper's call is one **region** of it, as a ``pallas_call``
is one equation of a jaxpr: the region holds the kernel's name, its
operands and results and an analytic cost (FLOPs and bytes, from shapes
only), and the walk does not descend into it. On the CPU the wrapper's
plain version runs inside the region with the walk's dispatch mode off; on
the card the region stands for the ctypes launch, which no dispatch mode
sees. So a step gives the same walk on both devices.

Each wrapper starts with one check, ``WALK is not None or x.is_meta`` on
its leading tensor, and calls ``run`` only when it holds: with no walk
active and no meta tensor the launch path is as it was. On meta tensors a
wrapper computes nothing: ``run`` returns empty tensors of the kernel's
output shapes (the wrapper's shape rule) and charges the region the
analytic cost — what the dry run (``repro_torch.launch.dryrun``) counts.

Collectives and sharded wrappers report to the walk here too:
``collective`` records one collective of ``repro_torch.dist.shard`` (its
kind, axes and the bytes it leaves on a device), ``sharded`` opens the
scope of a sharded wrapper whose operands are split over some mesh axes
(the bucket-merge invariant the analysis checks on it).
"""
from __future__ import annotations

import contextlib

WALK = None     # the active walk (repro_torch.analysis.op_walk.OpWalk)


def run(name: str, fn, args: tuple, kwargs: dict | None = None, *,
        meta: bool, shape, cost):
    """``fn(*args, **kwargs)`` as the region of kernel ``name``.

    ``meta``: the leading tensor is on the meta device, so
    ``shape(*args, **kwargs)`` gives the outputs instead. ``cost(*args,
    **kwargs)`` → ``{"flops": ..., "bytes": ...}`` is charged to the region
    when a walk is active. Inside the region no walk is active, so the
    wrapper's own check passes through to its launch (or plain) path."""
    global WALK
    kwargs = kwargs or {}
    walk = WALK
    if meta:
        out = shape(*args, **kwargs)
    elif walk is None:
        out = fn(*args, **kwargs)
    else:
        from torch.utils._python_dispatch import _disable_current_modes
        WALK = None
        try:
            with _disable_current_modes():
                out = fn(*args, **kwargs)
        finally:
            WALK = walk
    if walk is not None:
        walk.region(name, args, kwargs, out, cost(*args, **kwargs))
    return out


def collective(kind: str, axes, nbytes: int):
    """Record one collective (``"all-reduce"``, ``"all-gather"``,
    ``"all-to-all"``, ``"reduce-scatter"``) over ``axes`` that leaves
    ``nbytes`` on a device, when a walk is active."""
    if WALK is not None:
        WALK.collective(kind, tuple(axes), int(nbytes))


def sharded(name: str, split_axes, kept_axes=(), merges=None):
    """The scope of a sharded wrapper whose operands are split over
    ``split_axes`` and whose result stays split over ``kept_axes`` only:
    a context manager (a no-op with no walk active). ``merges``: the
    collectives that merge the split, ``(kind, axes)`` pairs (pairs with
    no axes dropped); None: one all-reduce over the axes split and not
    kept, the psum invariant."""
    if WALK is None:
        return contextlib.nullcontext()
    return WALK.scope(name, tuple(split_axes), tuple(kept_axes), merges)


def merged_by(*merges):
    """Declare the innermost open scope's merges (``(kind, axes)`` pairs)
    where they are known only inside it, as the a2a lookup's are once its
    plan says whether it spills; a no-op with no walk active."""
    if WALK is not None:
        WALK.declare_merges(merges)


def nbytes(*tensors) -> int:
    """Bytes of the tensors (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)
