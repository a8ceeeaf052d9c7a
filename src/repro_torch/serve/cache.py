"""Capture-once cell cache for serving executables.

A serving process handles many requests against few (arch, shape) pairs; the
cache makes the cost of building an executable a registration-time event,
as the reference's ``CellCache`` does with ahead-of-time compiled XLA
executables. On the card the executable is a **CUDA graph**: the step is
warmed on a side stream (building the kernels' libraries and the lookup's
launch descriptor), then captured once with ``torch.cuda.graph`` over a
static input tensor, and every later call copies the request into that
tensor and replays the graph — one launch for the whole forward, no Python
dispatch a kernel. On the CPU the executable is the eager step. A capture
that fails raises: there is no eager fallback on the card.

Keys are ``(arch, shape, device signature, bound tensors, mesh
signature)`` — the same cell on another mesh is another executable. A
cell runs under the cache's mesh (``repro_torch.dist.mesh.use_mesh``), which
its sharded lookups read. On a mesh of more than one rank a cell whose step
holds collectives (``meta["shard_lookup"]``) runs **eager** on the card and
is not captured: NCCL inside a CUDA graph cannot be checked on a one-card
machine. Every other cell, and every cell on a one-rank mesh (the host
mesh of one process), is a graph. A graph reads
its bound tensors (the packed table, the MLP) by address, so the same cell
over other tensors is another executable; a table swap therefore writes
the new table into the bound tensors in place (``Engine.request_swap``).
What a swap writes is the cache's own copy (``bind``), taken once per
source table: engines that register over one table share that copy and
its executables, and the caller's tensors are never written.

The graphs of one cache share one memory pool. That is safe because the
engine replays one cell at a time and reads each output before the next
replay: a replay may overwrite another cell's output, never an input.

Compile/hit counters are the reference's: ``compiles`` counts captures,
``hits`` the registrations that found a warm cell. ``CompiledCell.replays``
counts the calls of each executable, and ``launches`` the kernel launches
they made: a replay runs the kernels captured in it without calling their
Python wrappers, whose counts (``repro_torch.kernels.COUNTERS``) therefore
stay still. The launches each wrapper recorded into the graph are counted
at capture.
"""
from __future__ import annotations

import hashlib
import time
import weakref
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.device import resolve_device
from repro_torch.dist.mesh import host_mesh, use_mesh
from repro_torch.serve.batcher import RequestBatcher
from repro_torch.train.tree import leaves, tree_map

WARMUP_CALLS = 3       # eager calls on a side stream before the capture


def device_signature(device) -> str:
    """Stable identity of a device: its type, index and, for a card, its
    name."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return f"cuda:{index}:{torch.cuda.get_device_name(index)}"


def mesh_signature(mesh) -> str:
    """Stable identity of a mesh: shape, axis names, device type."""
    shape = "x".join(str(s) for s in mesh.devices.shape)
    return f"{shape}:{','.join(mesh.axis_names)}:{mesh.device_type}"


def bound_signature(bound) -> str:
    """Digest of the addresses, shapes and dtypes of the tensors in
    ``bound`` — what a captured graph reads by address."""
    sig = [(t.data_ptr(), tuple(t.shape), str(t.dtype))
           for t in leaves(bound) if torch.is_tensor(t)]
    return hashlib.sha1(repr(sig).encode()).hexdigest()[:12]


def _leading(request_specs) -> tuple:
    """The leading dim of each request input (None for a tree of inputs,
    such as a decode cell's KV caches, which is never staged)."""
    return tuple(None if isinstance(spec, dict) else spec[0][0]
                 for spec in request_specs)


def _zeros(spec, device):
    """A zeroed static input of ``spec``: a ``(shape, dtype)`` pair, or a
    dict of them (a tree of inputs)."""
    if isinstance(spec, dict):
        return {k: _zeros(v, device) for k, v in spec.items()}
    shape, dtype = spec
    return torch.zeros(shape, dtype=dtype, device=device)


def _copy_into(static, value):
    """Copy a request input into the graph's static input, leaf by leaf,
    skipping a leaf that already is the static tensor (a decode cell's
    caches, written in place by the last replay)."""
    if isinstance(static, dict):
        for k, x in static.items():
            _copy_into(x, value[k])
    elif value is not static:
        static.copy_(value)


class CellKey(NamedTuple):
    """Identity of one serving executable: the same (arch, shape) on another
    device or mesh, with other static config baked into the shape string's
    fingerprint, or over other bound tensors is another executable."""
    arch: str        # model/architecture identity, e.g. "dlrm"
    shape: str       # shape name + capacity + static-config digest,
                     # e.g. "serve_p99@512#3f9ab2c41d07"
    device_sig: str
    bound: str = ""  # bound_signature of the tensors the executable reads
    mesh_sig: str = ""   # mesh_signature of the mesh it runs on


class CompiledCell:
    """A warm serving executable: a captured CUDA graph on the card, the
    eager step on the CPU.

    ``stage(*request)`` puts host arrays where the executable reads them
    (the counterpart of the reference's ``device_put`` to the cell's input
    shardings), padding each input of fewer rows than the cell's with rows
    of zeros (id 0; False for a mask): on the card into the graph's static
    inputs, through pinned
    staging buffers padded in place, and returns them all; on the CPU into
    tensors, and returns those. A call that stages the leading inputs only
    always stages those.
    ``compiled(*request)`` runs the executable on them and returns its
    output — on the card the graph's static output, valid until the next
    replay of any cell of the cache."""

    def __init__(self, key: CellKey, step: Callable, *, compile_s: float,
                 meta: dict, rows: tuple, graph=None, inputs: tuple = (),
                 output=None, captured: dict | None = None, device=None):
        self.key = key
        self.device = torch.device(device or "cpu")   # an eager cell's
        self.rows = rows              # the leading dim of each input
        self.compile_s = compile_s
        self.meta = dict(meta)
        self.replays = 0
        # kernel name -> launches captured in the graph, made by a replay
        self.captured = dict(captured or {})
        self._step = step
        self._graph = graph
        self._inputs = inputs
        self._output = output
        self._staging: tuple = ()
        self._staged = None           # event: the staging buffers are free
        self._dirty: list = []        # rows of each buffer not known zero

    @property
    def name(self) -> str:
        return f"{self.key.arch}/{self.key.shape}"

    @property
    def inputs(self) -> tuple:
        """The graph's static request inputs on the card (empty on the
        CPU): what a replay reads."""
        return self._inputs

    @property
    def launches(self) -> dict:
        """Kernel launches this executable's calls made, by kernel name."""
        return {name: self.replays * n for name, n in self.captured.items()}

    def stage(self, *request) -> tuple:
        if self._graph is None:
            return tuple(torch.from_numpy(np.ascontiguousarray(
                RequestBatcher.pad(r, rows)[0])).to(self.device)
                for r, rows in zip(request, self.rows))
        if not self._staging:
            # pinned buffers for the inputs staged here (a tiered cell's
            # cold buffer comes staged by the engine)
            self._staging = tuple(
                torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                for x in self._inputs[:len(request)])
            self._staged = torch.cuda.Event()
            self._dirty = list(self.rows[:len(self._staging)])
        self._staged.synchronize()    # the last copy out of them has ended
        for k, (buf, x, r) in enumerate(zip(self._staging, self._inputs,
                                            request)):
            n = r.shape[0]
            if n > self.rows[k]:
                raise ValueError(f"chunk of {n} rows exceeds the cell's "
                                 f"{self.rows[k]}")
            rows = buf.numpy()
            np.copyto(rows[:n], r, casting="no")
            rows[n:self._dirty[k]] = 0     # the padding: rows of id 0
            self._dirty[k] = n
            x.copy_(buf, non_blocking=True)
        self._staged.record()
        return self._inputs

    def compiled(self, *request):
        if any(isinstance(r, np.ndarray) for r in request):
            request = self.stage(*request)
        self.replays += 1
        if self._graph is None:
            with torch.inference_mode():
                return self._step(*request)
        for x, r in zip(self._inputs, request):
            _copy_into(x, r)
        self._graph.replay()
        return self._output


class CellCache:
    """Capture-once memo of serving executables, keyed by ``CellKey``, on
    one device (the CUDA card unless the caller names another) and one mesh
    (default: ``host_mesh()``, 1×1 in one process).

    ``get_or_compile`` builds on first use and returns the warm
    ``CompiledCell`` afterwards; ``compiles``/``hits`` back the
    zero-recompile assertion of the serving path."""

    def __init__(self, device=None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else host_mesh()
        self._cells: dict[CellKey, CompiledCell] = {}
        self.compiles = 0
        self.hits = 0
        self._pool = None             # the graphs' shared memory pool
        # source leaves' (id, version) -> (weak refs to them, the copy, the
        # engines registered over the copy)
        self._bound: dict[tuple, tuple] = {}

    def key(self, arch: str, shape: str, bound=()) -> CellKey:
        return CellKey(arch, shape, device_signature(self.device),
                       bound_signature(bound), mesh_signature(self.mesh))

    def __contains__(self, key: CellKey) -> bool:
        return key in self._cells

    def __len__(self) -> int:
        return len(self._cells)

    def lookup(self, key: CellKey) -> CompiledCell | None:
        return self._cells.get(key)

    def bind(self, tree, holder, *, rows_axes=None):
        """The cache's copy of ``tree`` on its device, which executables
        read and a table swap writes; ``holder`` (an engine) is recorded as
        registered over it. One copy per source tensors, taken at the first
        ``bind``: later binds of the same, unchanged tensors return it, so
        their cells are hits. With ``rows_axes`` (a packed table served
        row-sharded on a mesh of more than one rank) the copy holds only
        this rank's row blocks (``repro_torch.dist.shard.place_table_rows``),
        cut once here."""
        src = [t for t in leaves(tree) if torch.is_tensor(t)]
        sig = (tuple((id(t), 0 if t.is_inference() else t._version)
                     for t in src), rows_axes)
        hit = self._bound.get(sig)
        if hit is None or any(r() is not t for r, t in zip(hit[0], src)):
            if rows_axes is not None:
                from repro_torch.dist.shard import place_table_rows
                tree = place_table_rows(tree, self.mesh, rows_axes)
            with torch.no_grad():
                copy = tree_map(
                    lambda t: t.detach().to(self.device, copy=True)
                    if torch.is_tensor(t) else t, tree)
            hit = ([weakref.ref(t) for t in src], copy, weakref.WeakSet())
            self._bound[sig] = hit
        hit[2].add(holder)
        return hit[1]

    def holders(self, tree) -> list:
        """The live engines registered over the bound copy whose tensors
        ``tree`` holds."""
        ptrs = [t.data_ptr() for t in leaves(tree) if torch.is_tensor(t)]
        for _, copy, engines in self._bound.values():
            if [t.data_ptr() for t in leaves(copy)
                    if torch.is_tensor(t)] == ptrs:
                return list(engines)
        return []

    def pool_bytes(self) -> int:
        """Bytes the graphs' shared memory pool holds on the card: what the
        captured cells keep for as long as they live (their activations
        and outputs), which a replay reuses without allocator calls."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)

    def get_or_compile(self, key: CellKey, build_fn: Callable) -> CompiledCell:
        """Return the cached executable for ``key``, building it on first
        use.

        ``build_fn() -> (step_fn, bound, request_specs, meta)`` is only
        invoked on a miss: ``step_fn(*bound, *request)`` on the cache's
        device, ``request_specs`` the requests' ``(shape, dtype)`` (or a
        dict of them for a tree of inputs)."""
        if key in self._cells:
            self.hits += 1
            return self._cells[key]
        step_fn, bound, request_specs, meta = build_fn()
        mesh = self.mesh

        def step(*request):
            with use_mesh(mesh):
                return step_fn(*bound, *request)

        t0 = time.perf_counter()
        if self.device.type == "cuda" and not self.eager(meta):
            cell = self._capture(key, step, request_specs, meta, t0)
        else:
            cell = CompiledCell(key, step, compile_s=0.0, meta=meta,
                                rows=_leading(request_specs),
                                device=self.device)
        self._cells[key] = cell
        self.compiles += 1
        return cell

    def eager(self, meta: dict) -> bool:
        """Whether a cell of ``meta`` runs eager on the card: one whose step
        holds collectives, on a mesh of more than one rank."""
        return self.mesh.size > 1 and bool(meta.get("shard_lookup"))

    def _capture(self, key, step, request_specs, meta, t0) -> CompiledCell:
        dev = self.device
        with torch.cuda.device(dev):
            inputs = tuple(_zeros(spec, dev) for spec in request_specs)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            # thread_local: no other thread's CUDA call can break it
            capture = torch.cuda.graph(graph, pool=self._pool,
                                       capture_error_mode="thread_local")
            # warm up on the side stream the capture then runs on: one
            # stream, and so one cuBLAS workspace, for every capture of
            # the process (a new stream each would keep one more each)
            side = capture.capture_stream
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), torch.inference_mode():
                for _ in range(WARMUP_CALLS):
                    step(*inputs)
            torch.cuda.current_stream().wait_stream(side)
            before = kernels.counts()
            try:
                with torch.inference_mode(), capture:
                    output = step(*inputs)
            except Exception as err:
                raise RuntimeError(f"capturing the serving cell {key.arch}/"
                                   f"{key.shape} as a CUDA graph failed: "
                                   f"{type(err).__name__}: {err}") from err
            finally:
                # a capture records launches, it makes none
                captured = {name: n - before[name]
                            for name, n in kernels.counts().items()
                            if n != before[name]}
                for name, n in before.items():
                    kernels.COUNTERS[name].launches = n
            # registration, not a request: the capture ends before the cell serves
            torch.cuda.synchronize(dev)  # staticcheck: ignore[RL403]
        return CompiledCell(key, step, compile_s=time.perf_counter() - t0,
                            meta=meta, rows=_leading(request_specs),
                            graph=graph, inputs=inputs, output=output,
                            captured=captured)

    def counters(self) -> dict:
        return {"compiles": self.compiles, "hits": self.hits,
                "cells": len(self._cells)}

    def replays(self) -> dict:
        """Calls of each executable, by cell name."""
        return {cell.name: cell.replays for cell in self._cells.values()}

    def launches(self) -> dict:
        """Kernel launches made by every executable's calls."""
        out: dict[str, int] = {}
        for cell in self._cells.values():
            for name, n in cell.launches.items():
                out[name] = out.get(name, 0) + n
        return out
