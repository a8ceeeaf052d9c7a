"""Context-managed current-mesh registry on ``torch.distributed``.

The port of the reference's ``repro.dist.mesh``. The reference runs one
program over many devices (JAX's multi-controller runtime); the port runs
one process per device, SPMD: every rank runs the same program on the same
inputs, and a ``Mesh`` names the grid those ranks form. Its axes are the
reference's — ``("data", "model")``, or ``("pod", "data", "model")`` across
pods — and each group of ranks along an axis, or along several axes taken
together, has a process group that carries the collectives of
``repro_torch.dist.shard``.

Where a process group is up, a mesh also holds the
``torch.distributed.device_mesh.DeviceMesh`` of its grid, with the same
axis names (``Mesh.device_mesh``): single axes take the DeviceMesh's own
groups, combined axes a group of their own. In one process with no group
(the default of every entry point: no launcher, no coordinator) the host
mesh is 1×1 and every wrapper takes its single-device path.

``use_mesh`` pushes onto a stack local to the process; ``current_mesh``
reads its top. Importing this module starts no process group.

A process that started the default group ends it: ``launch_session`` wraps
a launcher's run, ``end_distributed`` tears the group down (a barrier, then
``destroy_process_group``) only where ``init_distributed`` started it. A
rank that exits with its group alive can abort in the group's teardown at
exit while a peer still holds its connections.
"""
from __future__ import annotations

import contextlib
import datetime
import itertools
import os
import socket
import threading

import numpy as np
import torch
import torch.distributed as dist

_MESH_STACK: list["Mesh"] = []
_TIMEOUT: datetime.timedelta | None = None   # the group's, for new groups
_STARTED = None      # the default group init_distributed started, if any


def world_size() -> int:
    """Ranks in the default process group; 1 when none is up."""
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    """This process's rank in the default group; 0 when none is up."""
    return dist.get_rank() if dist.is_initialized() else 0


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     device=None, timeout: float | None = None) -> bool:
    """Bring up the default process group (``init_process_group``).

    Call once per process, before the first mesh. The coordinator
    (``host:port``), the process count and this process's index come from
    the arguments, or else from the environment a launcher such as
    ``torch.distributed.run`` sets (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``). With no coordinator and at most one process
    this is a no-op, as the reference's is — the single-process default of
    the launch CLIs. Idempotent: once a group is up it returns True and
    starts nothing. Returns True when a group is up; ``started_group``
    says whether this function started it (``end_distributed`` ends only
    such a group, never one the caller brought up).

    The backend is NCCL where ``device`` (default: the CUDA card when one
    is present) is a card, gloo otherwise; a card process takes the card
    of its ``LOCAL_RANK`` (default: its rank). ``timeout`` (seconds) bounds
    every collective of the group, so a rank that hangs fails the others
    instead of stalling them."""
    global _TIMEOUT, _STARTED
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator is None and num_processes in (None, 0, 1):
        return False
    if coordinator is None:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         f"(host:port, or MASTER_ADDR and MASTER_PORT)")
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs the process count and this "
                         "process's index (or WORLD_SIZE and RANK)")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    kwargs = {}
    if timeout is not None:
        _TIMEOUT = datetime.timedelta(seconds=timeout)
        kwargs["timeout"] = _TIMEOUT
    if device.type == "cuda":
        card = device.index if device.index is not None \
            else int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(card)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            **kwargs)
    _STARTED = dist.group.WORLD
    return True


def started_group() -> bool:
    """Whether the default group that is up now is the one
    ``init_distributed`` started (False when none is up, or when the
    caller brought the group up itself)."""
    return (_STARTED is not None and dist.is_initialized()
            and dist.group.WORLD is _STARTED)


def end_distributed(*, barrier: bool = True) -> bool:
    """End the default group where ``init_distributed`` started it: with
    ``barrier``, wait until every rank got here (so none tears down its
    connections while a peer still uses them), then
    ``destroy_process_group()``, which ends every group of the process.
    Leaves a group the caller brought up alone. Returns whether it ended
    one."""
    global _STARTED
    if not started_group():
        _STARTED = None
        return False
    if barrier and dist.get_world_size() > 1:
        dist.barrier()
    dist.destroy_process_group()
    _STARTED = None
    return True


@contextlib.contextmanager
def launch_session(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, *, device=None,
                   timeout: float | None = None):
    """A launcher's run: ``init_distributed`` on entry (yields whether a
    group is up); on exit, every thread started inside is joined, then
    ``end_distributed`` ends the group if this session started it — with
    a barrier when the run ended normally, without one after an error (a
    peer that failed would never reach it). A group that was up before
    the session is left as it was."""
    before = set(threading.enumerate())
    was_up = dist.is_initialized()
    up = init_distributed(coordinator, num_processes, process_id,
                          device=device, timeout=timeout)
    ok = False
    try:
        yield up
        ok = True
    finally:
        for t in threading.enumerate():
            if t not in before and t is not threading.current_thread():
                t.join()
        if not was_up:
            end_distributed(barrier=ok)


def host_boundary_groups() -> list[list[int]]:
    """The ranks grouped by the host that runs them, hosts in the order of
    their smallest rank — the boundary a leading ("pod", ...) mesh axis
    must align with so the inner ("data", "model") axes stay on one host.
    Gathers every rank's host name (a collective: every rank calls it);
    one process returns ``[[0]]``."""
    if world_size() == 1:
        return [[0]]
    names: list = [None] * world_size()
    dist.all_gather_object(names, socket.gethostname())
    groups: dict[str, list[int]] = {}
    for rank, name in enumerate(names):
        groups.setdefault(name, []).append(rank)
    return sorted(groups.values(), key=lambda g: g[0])


class Mesh:
    """A grid of ranks with named axes: the port's counterpart of
    ``jax.sharding.Mesh``.

    ``devices`` is the grid of global ranks (row-major ``arange``: under
    ``torch.distributed.run`` ranks are numbered host-major, so the grid
    walks hosts outermost), ``shape`` maps each axis to its size in mesh
    order, ``size`` counts the ranks. A mesh of more than one rank spans
    the whole default process group and creates, at construction, one
    process group per group of ranks along each set of its axes — a
    collective step every rank takes in the same order. ``device_type`` is
    what the ranks compute on ("cuda" or "cpu")."""

    def __init__(self, shape, axis_names, device_type: str | None = None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             f"differ in length")
        self.axis_names = axis_names
        self.devices = np.arange(int(np.prod(shape))).reshape(shape)
        self.shape = dict(zip(axis_names, shape))
        self.size = int(self.devices.size)
        if device_type is None:
            on_card = (dist.get_backend() == "nccl" if dist.is_initialized()
                       else torch.cuda.is_available())
            device_type = "cuda" if on_card else "cpu"
        self.device_type = device_type
        n_world = world_size()
        if self.size != n_world and self.size > 1:
            raise ValueError(f"a {self.size}-rank mesh needs a world of "
                             f"{self.size} ranks, not {n_world}")
        self.rank = world_rank() if self.size > 1 else 0
        self.coordinate = dict(zip(axis_names, (
            int(c) for c in np.unravel_index(self.rank, shape))))
        self.device_mesh = None
        self._groups: dict[tuple, object] = {}
        if dist.is_initialized() and self.size == n_world:
            from torch.distributed.device_mesh import DeviceMesh
            self.device_mesh = DeviceMesh(
                device_type, torch.from_numpy(self.devices),
                mesh_dim_names=axis_names)
        if self.size > 1:
            self._make_groups()

    def _make_groups(self):
        # a rank set's group: the world's, the DeviceMesh's own for one
        # axis (named here by the axis), or a new group for several axes
        by_ranks: dict[tuple, object] = {}
        world = tuple(range(self.size))
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                if self.axes_size(axes) == 1:
                    continue
                for ranks in self._rank_sets(axes):
                    if ranks in by_ranks:
                        pass
                    elif ranks == world:
                        by_ranks[ranks] = dist.group.WORLD
                    elif len(axes) == 1:
                        by_ranks[ranks] = axes[0]
                    else:
                        by_ranks[ranks] = dist.new_group(list(ranks),
                                                         timeout=_TIMEOUT)
                    if self.rank in ranks:
                        group = by_ranks[ranks]
                        if isinstance(group, str):
                            group = self.device_mesh.get_group(group)
                        self._groups[axes] = group

    def _rank_sets(self, axes) -> list[tuple]:
        """Every group of ranks along ``axes``: the others fixed, each
        group's ranks in row-major order over ``axes`` (ascending, as a
        process group orders its members)."""
        keep = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in keep]
        grid = self.devices.transpose(rest + keep).reshape(
            -1, self.axes_size(axes))
        return [tuple(int(r) for r in row) for row in grid]

    def axes_size(self, axes) -> int:
        """Ranks along ``axes`` taken together."""
        size = 1
        for a in axes:
            size *= self.shape[a]
        return size

    def axis_index(self, axes) -> int:
        """This rank's row-major index along ``axes`` (the reference's
        ``axis_index`` folded over the axes tuple)."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coordinate[a]
        return idx

    def group(self, axes):
        """The process group of this rank's ranks along ``axes`` (in mesh
        order), or None where they are one rank."""
        axes = tuple(a for a in self.axis_names if a in tuple(axes))
        return self._groups.get(axes)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device_type={self.device_type!r})"


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Install ``mesh`` as the current mesh for the dynamic extent.
    Nestable; the innermost mesh wins."""
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def current_mesh() -> Mesh | None:
    """The innermost ``use_mesh`` mesh, else None."""
    return _MESH_STACK[-1] if _MESH_STACK else None


def make_device_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...],
                     device_type: str | None = None) -> Mesh:
    """Mesh of ``shape`` over the ranks of the default process group
    (prod 16×16 / 2×16×16, tests 1×4 or 2×2 gloo ranks)."""
    return Mesh(shape, axis_names, device_type)


def parse_mesh_flag(flag: str | None) -> Mesh | None:
    """``--mesh`` CLI flag → a host mesh, or None.

    ``"dp,mp"`` (e.g. ``"2,2"``) builds a ("data", "model") mesh;
    ``"pod,dp,mp"`` (e.g. ``"1,2,2"``) a ("pod", "data", "model") multi-pod
    mesh. Fails loudly when the world holds fewer ranks than the product
    of the sizes (start the ranks with ``torch.distributed.run
    --nproc-per-node N``), and also when it holds more: a rank outside
    the mesh would run the program with nothing to do. ``"auto"`` spreads
    every rank on the data axis; None/"" disables."""
    if not flag:
        return None
    if flag == "auto":
        return host_mesh()
    try:
        sizes = tuple(int(x) for x in flag.split(","))
        if len(sizes) not in (2, 3) or min(sizes) < 1:
            raise ValueError(flag)
    except ValueError as e:
        raise SystemExit(
            f"--mesh expects 'dp,mp', 'pod,dp,mp' or 'auto', got {flag!r}"
        ) from e
    n_need = int(np.prod(sizes))
    n_world = world_size()
    if n_need > n_world:
        raise SystemExit(
            f"--mesh {flag}: needs {n_need} ranks, {n_world} running "
            f"(start them with python -m torch.distributed.run "
            f"--nproc-per-node {n_need})")
    if n_need < n_world:
        raise SystemExit(f"--mesh {flag}: {n_need} ranks, but {n_world} "
                         f"are running; the mesh must hold every rank")
    if len(sizes) == 2:
        return host_mesh(n_data=sizes[0], n_model=sizes[1])
    return host_mesh(n_data=sizes[1], n_model=sizes[2], n_pod=sizes[0])


def host_mesh(n_data: int | None = None, n_model: int = 1,
              n_pod: int | None = None) -> Mesh:
    """("data", "model") mesh over the running ranks — or, with ``n_pod``,
    the multi-pod ("pod", "data", "model") layout, whose "pod" axis must
    fall on host boundaries (each pod a whole number of hosts, checked).

    Defaults to every rank on the data axis: a 1×1 mesh in one process,
    on which every wrapper of ``repro_torch.dist.shard`` takes its
    single-device path."""
    n = world_size()
    if n_data is None:
        n_data = n // ((n_pod or 1) * n_model)
    if n_pod is None:
        return Mesh((n_data, n_model), ("data", "model"))
    hosts = host_boundary_groups()
    per_pod = n_data * n_model
    starts = {g[0] for g in hosts}
    if len(hosts) > 1 and not all(p * per_pod in starts
                                  for p in range(n_pod)):
        raise ValueError(f"pods of {per_pod} ranks do not fall on the host "
                         f"boundaries {[len(g) for g in hosts]}")
    return Mesh((n_pod, n_data, n_model), ("pod", "data", "model"))
