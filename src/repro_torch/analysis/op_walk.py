"""Op walk with source attribution: the port's counterpart of the
reference's ``jaxpr_walk``.

The reference traces a cell to a jaxpr and walks its equations. The port
runs eagerly, so it walks what a step *runs*: ``OpWalk`` is a
``TorchDispatchMode`` that records every aten op the step dispatches — its
name, its tensor inputs' and outputs' dtypes, shapes and bytes — with the
innermost **user frame**: the line of ``src/repro_torch`` (not of
``analysis/`` or ``kernels/region.py``, and not torch's own) whose Python
ran the op. That is what lets the precision pass tell a dequant routed
through ``core/quantizer.py`` from the same convert inlined at a call site,
as ``source_info_util.user_frame`` does for the reference.

Kernel calls are opaque **regions** (``repro_torch.kernels.region``), as
``pallas_call`` bodies are skipped by the reference's walk: a region item
holds the kernel's name, its operands and results and its analytic cost,
and the walk does not descend into the plain version that computes it on
the CPU. On the card the region stands for the ctypes launch. The same
step therefore gives the same walk on both devices.

**Collectives** are recorded where ``repro_torch.dist.shard`` issues them,
with their axes and the bytes they leave on a device, and each sharded
wrapper opens a **scope** naming the axes its operands are split over.

The walk also keeps the live bytes of the tensors the step's ops and
regions allocate (freed when Python drops them) and their peak: an
estimate of what the eager allocator holds, not of the caching
allocator's reserve.
"""
from __future__ import annotations

import contextlib
import os
import sys
import weakref
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import region as _region


class WalkItem(NamedTuple):
    """One recorded op, kernel region or collective."""
    kind: str                # "op" | "region" | "collective"
    name: str                # "aten.mul.Tensor" | kernel name | "all-reduce"
    in_dtypes: tuple         # dtype names of the tensor inputs
    in_shapes: tuple
    out_dtypes: tuple
    out_shapes: tuple
    file: str | None         # innermost user frame, when known
    line: int | None
    in_bytes: int = 0
    out_bytes: int = 0
    view: bool = False       # an aten view op (moves no bytes)
    flops: int = 0           # a region's analytic FLOPs
    bytes: int = 0           # a region's analytic bytes, a collective's
    axes: tuple = ()         # a collective's mesh axes
    scope: int | None = None  # index of the innermost sharded scope
    consts: str = ""         # an op's non-tensor arguments (scalars, dims)

    def signature(self) -> tuple:
        """What RC304 compares between two walks."""
        return (self.kind, self.name, self.in_dtypes, self.in_shapes,
                self.out_dtypes, self.out_shapes, self.axes, self.scope,
                self.consts)


class Scope(NamedTuple):
    """A sharded wrapper's extent: its operands split over ``split_axes``,
    its result still split over ``kept_axes`` only, merged by the
    collectives ``merges`` (``(kind, axes)`` pairs; None: the default of
    ``repro_torch.kernels.region.sharded``)."""
    name: str
    split_axes: tuple
    kept_axes: tuple
    file: str | None
    line: int | None
    parent: int | None
    merges: tuple | None = None


def _merges(merges):
    if merges is None:
        return None
    return tuple((kind, tuple(axes)) for kind, axes in merges if axes)


_HERE = ("/repro_torch/analysis/", "/repro_torch/kernels/region.py")
_USER: dict[str, bool] = {}


def _is_user(filename: str) -> bool:
    norm = filename.replace("\\", "/")
    return "/repro_torch/" in norm and not any(h in norm for h in _HERE)


def user_frame(depth: int = 1):
    """(file, line) of the innermost frame in ``src/repro_torch`` outside
    the analysis package, or (None, None)."""
    f = sys._getframe(depth)
    while f is not None:
        fn = f.f_code.co_filename
        ok = _USER.get(fn)
        if ok is None:
            ok = _USER[fn] = _is_user(fn)
        if ok:
            return os.path.abspath(fn), f.f_lineno
        f = f.f_back
    return None, None


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _consts(args, kwargs) -> str:
    """The non-tensor arguments of an op (scalars, dims, dtypes), as text:
    a constant that changes between two runs of a step changes this."""
    return repr([x for x in tree_leaves((args, kwargs))
                 if not isinstance(x, torch.Tensor)])


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _describe(tensors) -> tuple:
    return (tuple(dtype_name(t.dtype) for t in tensors),
            tuple(tuple(t.shape) for t in tensors),
            sum(t.numel() * t.element_size() for t in tensors))


class _Mode(TorchDispatchMode):
    def __init__(self, walk: "OpWalk"):
        super().__init__()
        self.walk = walk

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.walk._op(func, args, kwargs, out)
        return out


class OpWalk:
    """Record what a step runs::

        with OpWalk() as w:
            out = step(*inputs)
        w.items, w.scopes, w.peak_bytes

    One walk at a time: entering sets ``repro_torch.kernels.region.WALK``,
    which the kernel wrappers, collectives and sharded scopes read."""

    def __init__(self):
        self.items: list[WalkItem] = []
        self.scopes: list[Scope] = []
        self._stack: list[int] = []
        self._mode = None
        self.live_bytes = 0
        self.peak_bytes = 0

    # -- entering and leaving ------------------------------------------------
    def __enter__(self):
        if _region.WALK is not None:
            raise RuntimeError("an op walk is already active")
        _region.WALK = self
        self._mode = _Mode(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._mode.__exit__(*exc)
        finally:
            _region.WALK = None
            self._mode = None
        return False

    # -- what the step reports -------------------------------------------------
    def _scope_index(self):
        return self._stack[-1] if self._stack else None

    def _track(self, outs, ins):
        """Count the live bytes of newly allocated outputs (not inputs
        returned in place) until Python frees them."""
        seen = {id(t) for t in ins}
        for t in outs:
            if id(t) in seen:
                continue
            n = t.numel() * t.element_size()
            if n == 0:
                continue
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(t, self._free, n)

    def _free(self, n):
        self.live_bytes -= n

    def _op(self, func, args, kwargs, out):
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        idt, ish, ib = _describe(ins)
        odt, osh, ob = _describe(outs)
        file, line = user_frame(3)
        view = bool(getattr(func, "is_view", False))
        self.items.append(WalkItem(
            "op", str(func), idt, ish, odt, osh, file, line, ib, ob, view,
            scope=self._scope_index(), consts=_consts(args, kwargs)))
        if not view:
            self._track(outs, ins)

    def region(self, name, args, kwargs, out, cost):
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        idt, ish, ib = _describe(ins)
        odt, osh, ob = _describe(outs)
        file, line = user_frame(2)
        self.items.append(WalkItem(
            "region", name, idt, ish, odt, osh, file, line, ib, ob,
            flops=int(cost["flops"]), bytes=int(cost["bytes"]),
            scope=self._scope_index()))
        self._track(outs, ins)

    def collective(self, kind, axes, nbytes):
        file, line = user_frame(2)
        self.items.append(WalkItem(
            "collective", kind, (), (), (), (), file, line, bytes=nbytes,
            axes=tuple(axes), scope=self._scope_index()))

    @contextlib.contextmanager
    def scope(self, name, split_axes, kept_axes, merges=None):
        file, line = user_frame(3)
        self.scopes.append(Scope(name, tuple(split_axes), tuple(kept_axes),
                                 file, line, self._scope_index(),
                                 _merges(merges)))
        self._stack.append(len(self.scopes) - 1)
        try:
            yield
        finally:
            self._stack.pop()

    def declare_merges(self, merges):
        i = self._scope_index()
        if i is not None:
            self.scopes[i] = self.scopes[i]._replace(merges=_merges(merges))

    # -- reading it ----------------------------------------------------------
    def regions(self) -> list[WalkItem]:
        return [it for it in self.items if it.kind == "region"]

    def collectives(self) -> list[WalkItem]:
        return [it for it in self.items if it.kind == "collective"]

    def inside(self, scope: int) -> list[WalkItem]:
        """Every item recorded inside scope ``scope``, nested scopes
        included."""
        within = {scope}
        for i, s in enumerate(self.scopes):
            if s.parent in within:
                within.add(i)
        return [it for it in self.items if it.scope in within]

    def signature(self) -> list[tuple]:
        return [it.signature() for it in self.items]
