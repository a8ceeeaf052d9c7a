"""Training launcher: the MPE pipeline (search → sample → retrain → packed
export) on a synthetic CTR stream, or one of the paper's Table-3 baselines
trained by the ``Trainer`` (``plain``, ``lsq``, ``alpt``, ``qr``, ``pep``,
``optfs``), for a DLRM backbone or Wide & Deep.

Runs on the CUDA card unless ``--device`` names another; on the card, float32
matrix products and convolutions run in full float32 (TF32 off), as the
reference trains. ``--prefetch`` makes and stages the batches ahead of the
steps; ``--ckpt-dir`` checkpoints there and resumes from it at the start.

    python -m repro_torch.launch.train --arch dlrm-criteo --batch 65536 --steps 8 --retrain-steps 8
    python -m repro_torch.launch.train --arch wide-deep --reduced --device cpu --steps 50
    python -m repro_torch.launch.train --compressor alpt --reduced --device cpu --ckpt-dir /tmp/ckpt
    python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train --reduced --device cpu --mesh 2,2

``--mesh dp,mp`` trains on a mesh of ranks (``repro_torch.dist``; start
them with ``torch.distributed.run``, or name ``--coordinator``,
``--num-hosts`` and ``--host-id``): the batch data-parallel, the embedding
rows sharded over "model" with row-shard-local updates. After the MPE
pipeline the packed table is looked up on the mesh through
``--lookup-comms`` (and ``--bucket-capacity``) and held bit for bit against
the single-device lookup (``[train] lookup check ...: bit_exact=True``).
A run that started its process group ends it
(``repro_torch.dist.mesh.launch_session``): every rank waits at a barrier,
then destroys the group.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.api import get_compressor
from repro_torch.core.mpe import MPEConfig
from repro_torch.core.pipeline import run_mpe_pipeline
from repro_torch.data.synthetic import CTRSpec, SyntheticCTR
from repro_torch.device import full_float32, resolve_device
from repro_torch.dist.mesh import launch_session, parse_mesh_flag
from repro_torch.dist.shard import rows_shard_index
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import adam
from repro_torch.zoo import dlrm_builder, wide_deep_builder

COMPRESSORS = ("mpe", "plain", "lsq", "alpt", "qr", "pep", "optfs")


def comp_config(compressor: str, steps: int) -> dict:
    """The reference launcher's ``comp_cfg`` of a baseline."""
    return ({"bits": 6} if compressor == "lsq" else
            {"bits": 8} if compressor == "alpt" else
            {"total_steps": steps} if compressor == "optfs" else {})


def _check_packed_lookup(res, mesh, *, lookup_comms, bucket_capacity,
                         seed) -> bool:
    """Post-train packed-lookup parity check on the training mesh: the
    row-sharded lookup of the just-packed table through the selected comms
    path, held bit for bit against the single-device lookup, with the a2a
    path's routing counters — how the chosen ``--bucket-capacity`` routes
    this table's traffic. Raises when they differ."""
    from repro_torch.core.inference import packed_lookup
    from repro_torch.dist.shard import (lookup_route_stats,
                                        sharded_packed_lookup)

    table, meta = res["packed_table"], res["packed_meta"]
    rng = np.random.default_rng(seed)
    dev = table["width_idx"].device
    ids = torch.from_numpy(rng.integers(0, meta["n"], size=(512,))
                           .astype(np.int32)).to(dev)
    want = packed_lookup(table, meta, ids)
    got = sharded_packed_lookup(table, meta, ids, mesh=mesh,
                                lookup_comms=lookup_comms,
                                bucket_capacity=bucket_capacity)
    exact = bool(torch.equal(want, got))
    line = f"[train] lookup check ({lookup_comms}): bit_exact={exact}"
    if lookup_comms == "a2a":
        stats = lookup_route_stats(table, meta, ids,
                                   n_shards=mesh.shape["model"],
                                   bucket_capacity=bucket_capacity)
        line += (f" capacity={stats['capacity']} routed={stats['routed']} "
                 f"bucketed={stats['bucketed']} spilled={stats['spilled']}")
    print(line)
    if not exact:
        raise SystemExit("[train] sharded packed lookup diverged from the "
                         "single-device lookup")
    return exact


def projection_hook(compressor: str, comp_cfg: dict, params, gen, mesh=None):
    """The ``Trainer``'s ``post_update`` for ``compressor``, or None where
    it projects nothing: ALPT's stochastic rounding onto its grid after
    each step, uniforms from ``gen``. On a mesh the Trainer holds a row
    shard of the table wherever the row shards divide it; the hook then
    projects that shard with the whole table's uniforms for its rows, as
    one device would."""
    if compressor != "alpt":
        return None
    comp = get_compressor(compressor)
    n_rows = params["embedding"]["emb"].shape[0]

    def post(p):
        rows_loc = p["embedding"]["emb"].shape[0]
        shard = (0, 1)
        if rows_loc != n_rows:
            shard = (rows_shard_index(mesh, ("model",)), n_rows // rows_loc)
        comp.post_update(p["embedding"], {}, comp_cfg, gen, row_shard=shard)
        return p
    return post


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="dlrm-criteo",
                    help="dlrm-criteo | wide-deep")
    ap.add_argument("--backbone", default="dnn",
                    help="dnn | dcn | deepfm | ipnn (dlrm-criteo)")
    ap.add_argument("--compressor", default="mpe", help=" | ".join(COMPRESSORS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--retrain-steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--lam", type=float, default=3e-5)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="the config cut to a few fields of 1,000 ids")
    ap.add_argument("--prefetch", action="store_true",
                    help="make and stage batches ahead of the steps "
                         "(repro_torch.cache.PrefetchPipeline); "
                         "loss-identical to the synchronous loop")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint here, and resume from here at the start")
    ap.add_argument("--mesh", default=None,
                    help="'dp,mp', 'pod,dp,mp' or 'auto': train on a (data, "
                         "model) — or (pod, data, model) — mesh of ranks "
                         "(repro_torch.dist): the batch data-parallel over "
                         "the mesh, the embedding rows sharded over model "
                         "with row-shard-local updates. Start the ranks "
                         "with python -m torch.distributed.run "
                         "--nproc-per-node N")
    ap.add_argument("--lookup-comms", choices=("psum", "a2a"), default="psum",
                    help="model-axis comms of the post-train packed lookup "
                         "check under --mesh: 'psum' merges dequantized "
                         "partials, 'a2a' shuffles ids and ships back "
                         "packed words (bit-exact either way, route stats "
                         "printed)")
    ap.add_argument("--bucket-capacity", type=int, default=None,
                    help="a2a ids per destination shard per batch slice "
                         "(default: the full slice); overflow spills to an "
                         "integer all_reduce")
    ap.add_argument("--coordinator", default=None,
                    help="multi-host: coordinator host:port of the process "
                         "group (default: MASTER_ADDR:MASTER_PORT)")
    ap.add_argument("--num-hosts", type=int, default=None,
                    help="multi-host: total process count (default: "
                         "WORLD_SIZE)")
    ap.add_argument("--host-id", type=int, default=None,
                    help="multi-host: this process's index in [0, num-hosts) "
                         "(default: RANK)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.compressor not in COMPRESSORS:
        raise SystemExit(f"unknown --compressor {args.compressor!r}")
    device = resolve_device(args.device)
    full_float32(device)
    with launch_session(args.coordinator, args.num_hosts, args.host_id,
                        device=device):
        return _run(args, device)


def _run(args, device) -> dict:
    """The run of ``main`` once the process group (if any) is up."""
    mesh = parse_mesh_flag(args.mesh)
    if mesh is not None:
        print(f"[train] mesh: {mesh.shape} (rank {mesh.rank})")

    spec = get_arch(args.arch)
    if args.arch == "wide-deep":
        cfg, builder_fn = spec.make_config(args.reduced), wide_deep_builder
    else:
        cfg = spec.make_config(args.reduced, backbone=args.backbone)
        builder_fn = dlrm_builder
    ds = SyntheticCTR(CTRSpec(field_vocabs=tuple(f.vocab for f in cfg.fields),
                              batch_size=args.batch, seed=args.seed))
    eval_batches = ds.eval_set(4)
    build = builder_fn(cfg, ds.expected_frequencies(), lam=args.lam,
                       eval_batches=eval_batches, device=device)
    print(f"[train] {args.arch} on {device}: {len(cfg.fields)} fields, "
          f"batch {args.batch}, compressor {args.compressor}")

    if args.compressor == "mpe":
        res = run_mpe_pipeline(
            build, ds.batch, seed=args.seed, mpe_cfg=MPEConfig(lam=args.lam),
            optimizer=adam(args.lr), search_steps=args.steps,
            retrain_steps=args.retrain_steps or args.steps,
            eval_fn=build(args.seed, "plain", {})["eval_fn"],
            ckpt_dir=args.ckpt_dir, prefetch=args.prefetch, mesh=mesh)
        print(f"[train] MPE ratio={res['storage_ratio']:.4f} "
              f"avg_bits={res['avg_bits']:.2f} eval={res['eval']}")
        res["cfg"] = cfg
        if mesh is not None and mesh.shape.get("model", 1) > 1:
            res["lookup_check"] = _check_packed_lookup(
                res, mesh, lookup_comms=args.lookup_comms,
                bucket_capacity=args.bucket_capacity, seed=args.seed)
        return res

    comp_cfg = comp_config(args.compressor, args.steps)
    bundle = build(args.seed, args.compressor, comp_cfg)
    comp = get_compressor(args.compressor)
    post = projection_hook(
        args.compressor, comp_cfg, bundle["params"],
        torch.Generator(device=device).manual_seed(args.seed + 1), mesh)

    trainer = Trainer(bundle["loss_fn"], bundle["params"], bundle["buffers"],
                      bundle["state"], adam(args.lr), ckpt_dir=args.ckpt_dir,
                      post_update=post, mesh=mesh)
    start = trainer.step if trainer.restore() else 0
    t0 = time.perf_counter()
    trainer.run(ds.batch, args.steps, prefetch=args.prefetch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0
    ev = bundle["eval_fn"](trainer.params, bundle["buffers"], trainer.state)
    r = comp.storage_ratio(trainer.params["embedding"],
                           bundle["buffers"]["embedding"], comp_cfg)
    print(f"[train] {args.compressor} ratio={r:.4f} eval={ev}")
    return {"params": trainer.params, "state": trainer.state,
            "buffers": bundle["buffers"], "history": trainer.history,
            "eval": ev, "storage_ratio": r, "cfg": bundle["cfg"],
            "comp_cfg": comp_cfg, "trainer": trainer, "start_step": start,
            "train_s": train_s}


if __name__ == "__main__":
    main()
