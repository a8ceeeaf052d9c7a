"""Gloo ranks on the CPU for the port's distribution tests.

A test computes the reference's outputs with JAX in its own process, then
calls ``run_world(suite, inputs, tmp_path, mesh_shape)``: it pickles the
numpy inputs, starts one process per rank running this file, and returns
each rank's outputs. The ranks import no ``jax`` (this file imports only
torch, numpy and ``repro_torch``); they meet through a ``FileStore`` under
``tmp_path``, so test files running side by side never share a port, and
the world has a wall limit, so a hung rank fails its test instead of
stalling the suite.

Each suite is a function of (mesh, inputs) returning a dict of numpy
outputs; the parent compares them.
"""
from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
WALL_S = 120          # a world's wall limit
GROUP_TIMEOUT_S = 60  # every collective's


def run_world(suite: str, inputs: dict, tmp_path, mesh_shape,
              world: int = 4) -> list[dict]:
    """Run ``suite`` on ``world`` gloo ranks over a mesh of ``mesh_shape``
    → each rank's outputs. Raises when a rank fails or the world outlasts
    ``WALL_S``; every rank is stopped either way."""
    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({"mesh_shape": tuple(mesh_shape), **inputs}, f)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__)), suite, str(rank), str(world),
         str(tmp)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]
    deadline = time.monotonic() + WALL_S
    logs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"{suite} on {mesh_shape}: ranks {bad} failed:\n"
                           + "\n".join(logs[r][-4000:] for r, _ in bad))
    outs = []
    for rank in range(world):
        with open(tmp / f"rank{rank}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------

def _np(x):
    import torch
    if torch.is_tensor(x):
        return x.detach().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x


def _mesh(shape):
    from repro_torch.dist.mesh import host_mesh
    if len(shape) == 2:
        return host_mesh(n_data=shape[0], n_model=shape[1])
    return host_mesh(n_data=shape[1], n_model=shape[2], n_pod=shape[0])


def suite_kernels(mesh, inp) -> dict:
    """Every sharded kernel wrapper on ``mesh``: the packed lookup (psum
    and a2a at every capacity, over the whole table and over this rank's
    row blocks), the tiered hot lookup, flash attention and the QAT
    expectation (forward and gradients), the bag (forward and
    gradients)."""
    import torch
    from repro_torch.dist import shard
    from repro_torch.interop import to_torch

    out = {}
    table = to_torch(inp["table"], "cpu")
    meta = inp["meta"]
    ids = torch.from_numpy(inp["ids"])
    placed = shard.place_table_rows(table, mesh)
    for comms, cap in inp["lookup_cases"]:
        out[f"lookup/{comms}/{cap}"] = shard.sharded_packed_lookup(
            table, meta, ids, mesh=mesh, lookup_comms=comms,
            bucket_capacity=cap)
        if mesh.size > 1:
            out[f"placed/{comms}/{cap}"] = shard.sharded_packed_lookup(
                placed, meta, ids, mesh=mesh, lookup_comms=comms,
                bucket_capacity=cap, row_blocks=True)
    out["placed/rows"] = {k: int(v.shape[0])
                          for k, v in placed["subtables"].items()}
    hot = to_torch(inp["hot"], "cpu")
    hot["is_hot"] = hot["is_hot"].to(torch.bool)
    for comms, cap in inp["tiered_cases"]:
        out[f"tiered/{comms}/{cap}"] = shard.sharded_tiered_hot_lookup(
            hot, meta["bits"], meta["d"], ids, mesh=mesh, lookup_comms=comms,
            bucket_capacity=cap)

    q, k, v, do = (torch.from_numpy(inp["flash"][n])
                   for n in ("q", "k", "v", "do"))
    with torch.no_grad():
        out["flash/fwd"] = shard.sharded_flash_attention(q, k, v, mesh=mesh)
    qkv = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = shard.sharded_flash_attention(*qkv, mesh=mesh)
    (o * do).sum().backward()
    out["flash/o"] = o
    out["flash/grads"] = [x.grad for x in qkv]

    qat = {n: torch.from_numpy(np.array(x)) for n, x in inp["qat"].items()
           if n != "bits"}
    bits = inp["qat"]["bits"]
    xs = [qat[n].clone().requires_grad_(True)
          for n in ("rows", "probs", "alpha", "beta")]
    e = shard.sharded_mixed_expectation(*xs, bits, mesh=mesh)
    (e * qat["g"]).sum().backward()
    out["qat/fwd"] = e
    out["qat/grads"] = [x.grad for x in xs]

    bag = {n: torch.from_numpy(x) for n, x in inp["bag"].items()}
    tab = bag["table"].clone().requires_grad_(True)
    b = shard.sharded_embedding_bag(tab, bag["ids"], bag["mask"], mesh=mesh)
    (b * bag["g"]).sum().backward()
    out["bag/fwd"] = b
    out["bag/grad"] = tab.grad
    out["coordinate"] = dict(mesh.coordinate)
    return {k: _np(v) for k, v in out.items()}


def _ctr_model(inp):
    """The port's DLRM carried from the reference's numpy trees, its loss
    and the data stream."""
    from repro_torch.data.synthetic import CTRSpec, SyntheticCTR
    from repro_torch.embeddings.table import FieldSpec
    from repro_torch.interop import model_from_numpy
    from repro_torch.models.dlrm import DLRM, DLRMConfig

    m = inp["model"]
    cfg = DLRMConfig(fields=tuple(FieldSpec(f"f{i}", v)
                                  for i, v in enumerate(m["vocabs"])),
                     d_embed=m["d"], mlp_hidden=tuple(m["hidden"]),
                     backbone="dnn", use_batchnorm=False,
                     compressor=m["compressor"], comp_cfg=m["comp_cfg"])
    params, state, buffers = model_from_numpy(m["params"], m["state"],
                                              m["buffers"], cfg, "cpu")

    def loss_fn(p, bu, st, batch, *, step=None):
        return DLRM.loss_fn(p, bu, st, batch, cfg, lam=m["lam"], train=True,
                            step=step)

    ds = SyntheticCTR(CTRSpec(field_vocabs=tuple(m["vocabs"]),
                              batch_size=m["batch"], seed=m["seed"]))
    return params, buffers, state, loss_fn, ds


def suite_train(mesh, inp) -> dict:
    """``sharded_value_and_grad`` on one batch (its table gradients
    gathered whole), then ``Trainer(mesh=)`` steps: the trajectory, the
    gathered parameters, and one step at a clip tight enough to bind."""
    import torch
    from repro_torch.dist import shard
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import adam
    from repro_torch.train.tree import leaves

    out = {}
    params, buffers, state, loss_fn, ds = _ctr_model(inp)
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in ds.batch(0).items()}
    vag = shard.sharded_value_and_grad(loss_fn, mesh)
    (loss, _), grads = vag(params, buffers, state, batch,
                           step=torch.zeros((), dtype=torch.int32))
    flags = shard.table_shard_flags(params, mesh, ("model",))
    rows_ax = tuple(a for a in ("model",) if a in mesh.shape)
    out["vag/loss"] = loss
    out["vag/grads"] = [shard.all_gather(g, mesh, rows_ax) if f else g
                        for g, f in zip(grads, flags)]
    out["vag/local_rows"] = [int(g.shape[0]) if g.ndim else 0
                             for g in grads]
    out["vag/flags"] = flags

    n_steps = inp["train_steps"]
    params, buffers, state, loss_fn, ds = _ctr_model(inp)
    trainer = Trainer(loss_fn, params, buffers, state, adam(1e-3), mesh=mesh)
    trainer.run(ds.batch, n_steps, log_every=0)
    out["trainer/history"] = [{k: h[k] for k in ("loss", "grad_norm",
                                                  "skipped")}
                              for h in trainer.history]
    out["trainer/params"] = leaves(trainer.params)
    out["trainer/local_shapes"] = [tuple(x.shape)
                                   for x in leaves(trainer.carry["params"])]

    # each rank checkpoints its own carry (its row shards)
    params, buffers, state, loss_fn, ds = _ctr_model(inp)
    ckpt = os.path.join(inp["ckpt_root"], "ckpt")
    saved = Trainer(loss_fn, params, buffers, state, adam(1e-3), mesh=mesh,
                    ckpt_dir=ckpt)
    saved.run(ds.batch, 1, log_every=0)
    torch.distributed.barrier()
    out["ckpt/dirs"] = sorted(os.listdir(ckpt))
    params, buffers, state, loss_fn, ds = _ctr_model(inp)
    again = Trainer(loss_fn, params, buffers, state, adam(1e-3), mesh=mesh,
                    ckpt_dir=ckpt)
    out["ckpt/restored"] = again.restore() and again.step == 1
    out["ckpt/same"] = all(torch.equal(a, b) for a, b in zip(
        leaves(again.carry["params"]), leaves(saved.carry["params"])))

    params, buffers, state, loss_fn, ds = _ctr_model(inp)
    tight = Trainer(loss_fn, params, buffers, state, adam(1e-3), mesh=mesh,
                    clip_norm=inp["tight_clip"])
    tight.run(ds.batch, 1, log_every=0)
    out["tight/history"] = tight.history
    out["tight/params"] = leaves(tight.params)
    return {k: _np(v) for k, v in out.items()}


def suite_engine(mesh, inp) -> dict:
    """Engines on the mesh over one packed DLRM: psum and a2a score cells
    and the tiered lane against a 1×1 engine's scores, their compile and
    hit counters across repeated shapes, and the cells a shared cache
    registers for psum and a2a."""
    import torch
    from repro_torch.cache.tiers import TieredTableStore
    from repro_torch.configs.base import get_arch
    from repro_torch.data.synthetic import SyntheticCTR
    from repro_torch.dist.mesh import host_mesh
    from repro_torch.launch.serve import build_engine, build_packed_dlrm
    from repro_torch.models.dlrm import DLRM
    from repro_torch.serve.cache import CellCache
    from repro_torch.serve.engine import Engine

    out = {}
    cfg = get_arch("dlrm-criteo").make_config(reduced=True)
    params, buffers, state, spec = build_packed_dlrm(cfg, seed=4,
                                                     device="cpu")
    sizes = inp["request_rows"]
    requests = [SyntheticCTR(spec._replace(batch_size=n)).batch(50_000 + i)
                ["ids"] for i, n in enumerate(sizes)]
    shapes = dict(p99_rows=64, bulk_rows=256)
    one = build_engine(cfg, params, state, buffers, device="cpu",
                       mesh=host_mesh(1, 1), **shapes)
    out["ref"] = [one.score(ids) for ids in requests]

    for name, kw in (("psum", {}),
                     ("a2a", {"lookup_comms": "a2a", "bucket_capacity": 16})):
        engine = build_engine(cfg, params, state, buffers, device="cpu",
                              mesh=mesh, **shapes, **kw)
        if name == "psum":
            psum_engine = engine
        out[f"{name}/first"] = [engine.score(ids) for ids in requests]
        compiles = engine.compile_count
        out[f"{name}/again"] = [engine.score(ids) for ids in requests]
        out[f"{name}/compiles"] = (compiles, engine.compile_count)
        out[f"{name}/hits"] = engine.counters()["hits"]
        out[f"{name}/keys"] = sorted(tuple(k) for k in engine.cache._cells)

    # the psum engine binds this rank's row blocks of the table; a swap
    # writes the new table's blocks into them, and its scores stay one
    # device's
    reg = next(iter(psum_engine._score.values()))
    out["psum/bound_rows"] = {k: int(v.shape[0]) for k, v in
                              reg.bound[0]["embedding"]["subtables"].items()}
    out["table_rows"] = {k: int(v.shape[0]) for k, v in
                         params["embedding"]["subtables"].items()}
    gen = torch.Generator().manual_seed(11)
    new = {**params["embedding"],
           "subtables": {k: torch.randint(-2**31, 2**31 - 1, v.shape,
                                          generator=gen, dtype=v.dtype)
                         for k, v in params["embedding"]["subtables"].items()},
           "alpha": params["embedding"]["alpha"] * 1.5}
    meta = buffers["embedding"]["meta"]
    for name, e in (("one", one), ("mesh", psum_engine)):
        e.request_swap(new, meta)
        out[f"swap/{name}"] = [e.score(ids) for ids in requests]

    # one cache on the mesh: psum, then a2a, then psum again over one table
    cache = CellCache("cpu", mesh=mesh)
    counters = []
    for kw in ({}, {"lookup_comms": "a2a"}, {}):
        Engine(cache=cache).register_packed_model(
            "dlrm", DLRM, cfg, params, state, buffers,
            shapes={"serve_p99": 64}, shard_lookup=True, **kw)
        counters.append(dict(cache.counters()))
    out["shared/counters"] = counters

    freqs = SyntheticCTR(spec).expected_frequencies()
    tiered = {}
    for name, m in (("one", host_mesh(1, 1)), ("mesh", mesh)):
        store = TieredTableStore(params["embedding"],
                                 buffers["embedding"]["meta"], freqs, 0.3,
                                 row_pad_multiple=8, device="cpu")
        engine = build_engine(cfg, params, state, buffers, device="cpu",
                              mesh=m, store=store, **shapes)
        tiered[name] = [engine.score_tiered(ids) for ids in requests]
    out["tiered"] = tiered
    return out


def alpt_trainer(inp, mesh=None):
    """ALPT's Trainer with its projection hook as the train launcher builds
    it (``projection_hook``), after ``inp["train_steps"]`` steps."""
    import torch
    from repro_torch.launch.train import projection_hook
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import adam

    params, buffers, state, loss_fn, ds = _ctr_model(inp)
    m = inp["model"]
    post = projection_hook("alpt", m["comp_cfg"], params,
                           torch.Generator().manual_seed(m["seed"] + 1),
                           mesh)
    trainer = Trainer(loss_fn, params, buffers, state, adam(1e-3),
                      mesh=mesh, post_update=post)
    trainer.run(ds.batch, inp["train_steps"], log_every=0)
    return trainer


def suite_alpt(mesh, inp) -> dict:
    """ALPT's Trainer on ``mesh``, its table projected shard by shard: the
    losses, the whole trained tree and the shard each rank held."""
    from repro_torch.train.tree import leaves

    trainer = alpt_trainer(inp, mesh)
    return _np({"history": [h["loss"] for h in trainer.history],
                "params": leaves(trainer.params),
                "emb_rows": int(trainer.carry["params"]["embedding"]["emb"]
                                .shape[0])})


SUITES = {"kernels": suite_kernels, "train": suite_train,
          "engine": suite_engine, "alpt": suite_alpt}


def main(suite: str, rank: int, world: int, tmp: str):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        out = SUITES[suite](_mesh(inp["mesh_shape"]), inp)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
