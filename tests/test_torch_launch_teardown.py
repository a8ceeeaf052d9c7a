"""A launcher that started its process group ends it.

Each launcher's ``main`` runs in this process on a gloo group of one rank
that it starts itself (from ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``
and ``RANK``): afterwards no group is up and no thread it started is
alive. Handed a group that is already up, it leaves the group alone. A
rank that exits with its group alive can abort in the group's teardown at
interpreter exit while a peer still holds its connections.
"""
import socket
import threading

import pytest
import torch
import torch.distributed as dist

from repro_torch.dist import mesh as dmesh
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train

SERVE = ["--reduced", "--device", "cpu", "--requests", "2", "--batch", "40",
         "--p99-rows", "64", "--bulk-rows", "256"]
TRAIN = ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "256"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def world_of_one(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("main,args", [(launch_serve.main, SERVE),
                                       (launch_train.main, TRAIN)],
                         ids=["serve", "train"])
def test_launcher_destroys_the_group_it_started(main, args, world_of_one,
                                                monkeypatch):
    before = set(threading.enumerate())
    seen = {}

    def spy(flag):       # runs inside the session, the group up
        seen["up"] = dist.is_initialized() and dmesh.started_group()
        return dmesh.parse_mesh_flag(flag)

    module = launch_serve if main is launch_serve.main else launch_train
    monkeypatch.setattr(module, "parse_mesh_flag", spy)
    main(args)
    assert seen["up"]
    assert not dist.is_initialized()
    assert not dmesh.started_group()
    assert not [t for t in threading.enumerate()
                if t not in before and t.is_alive()]


@pytest.mark.parametrize("how", ["torch", "init_distributed"])
@pytest.mark.parametrize("main,args", [(launch_serve.main, SERVE),
                                       (launch_train.main, TRAIN)],
                         ids=["serve", "train"])
def test_launcher_leaves_a_group_it_was_handed(main, args, how,
                                               world_of_one):
    import os
    if how == "torch":
        dist.init_process_group(
            "gloo",
            init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}",
            world_size=1, rank=0)
    else:
        assert dmesh.init_distributed(device="cpu")
    group = dist.group.WORLD
    main(args)
    assert dist.is_initialized() and dist.group.WORLD is group
    assert dmesh.started_group() == (how == "init_distributed")


def test_session_joins_its_threads_and_ends_its_group(world_of_one):
    done = threading.Event()
    with dmesh.launch_session(device="cpu") as up:
        assert up and dmesh.started_group()
        t = threading.Thread(target=lambda: done.wait(0.2) or done.set())
        t.start()
    assert done.is_set() and not t.is_alive()
    assert not dist.is_initialized()


def test_session_after_an_error_ends_the_group_without_a_barrier(
        world_of_one):
    with pytest.raises(RuntimeError, match="boom"):
        with dmesh.launch_session(device="cpu"):
            raise RuntimeError("boom")
    assert not dist.is_initialized()


def test_no_coordinator_no_group(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with dmesh.launch_session(device="cpu") as up:
        assert up is False
    assert not dmesh.end_distributed()
