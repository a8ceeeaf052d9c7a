"""Serving launcher: score a synthetic CTR request stream from a packed table.

Builds a DLRM whose embedding is the bit-packed mixed-precision table of
paper §4, the way the reference's ``Packed.init`` does (the search layer's
init, random γ scaled by 0.01, Eq. 11 sampling, the packed export) with
weights drawn from ``--seed`` and the Zipf frequency prior of
``SyntheticCTR``; or, with ``--train-steps N``, the table and MLP that the
MPE pipeline trains in N search and N retrain steps on that stream
(``train_packed_dlrm``, as the reference's launcher serves). It registers
the ``serve_p99`` and ``serve_bulk`` cells,
sends ``--requests`` requests of ``--batch`` rows (padded onto the p99
cell) and optionally one ``--bulk`` job, and prints per-cell p50/p99 latency
in the Figure-5 lookup-vs-compute split.

Runs on the CUDA card unless ``--device`` names another:

    python -m repro_torch.launch.serve --arch dlrm-criteo --requests 20 --batch 300 --bulk 300000
    python -m repro_torch.launch.serve --arch dlrm-criteo --reduced --device cpu --train-steps 20
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs.base import SERVE_ROWS, get_arch
from repro_torch.core.compressors import Packed
from repro_torch.core.mpe import MPEConfig
from repro_torch.core.pipeline import run_mpe_pipeline
from repro_torch.data.synthetic import CTRSpec, SyntheticCTR
from repro_torch.device import full_float32, resolve_device
from repro_torch.embeddings.table import FieldSpec
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.serve.engine import Engine
from repro_torch.train.optimizer import adam
from repro_torch.zoo import dlrm_builder

DEFAULT_VOCABS = (2000, 1000, 1500, 800)


def train_packed_dlrm(*, field_vocabs=DEFAULT_VOCABS, train_steps: int = 120,
                      train_batch: int = 1024, d_embed: int = 16,
                      mlp_hidden=(64, 32), lam: float = 3e-5, seed: int = 0,
                      device=None):
    """The MPE pipeline in brief → (serve cfg, params, state, buffers, dataset
    spec, pipeline result): the packed table and the retrained interaction
    net are what the engine binds at cell registration. Runs on ``device``
    (the CUDA card unless the caller names another)."""
    device = resolve_device(device)
    full_float32(device)
    spec = CTRSpec(field_vocabs=tuple(field_vocabs), batch_size=train_batch,
                   seed=seed)
    ds = SyntheticCTR(spec)
    fields = tuple(FieldSpec(f"f{i}", v) for i, v in enumerate(spec.field_vocabs))
    base = DLRMConfig(fields=fields, d_embed=d_embed, mlp_hidden=tuple(mlp_hidden),
                      backbone="dnn")
    build = dlrm_builder(base, ds.expected_frequencies(), lam=lam, device=device)
    res = run_mpe_pipeline(build, ds.batch, seed=seed,
                           mpe_cfg=MPEConfig(lam=lam), optimizer=adam(1e-3),
                           search_steps=train_steps, retrain_steps=train_steps,
                           log_fn=lambda *a: None)
    meta = res["packed_meta"]
    cfg = base._replace(compressor="packed",
                        comp_cfg={"bits": meta["bits"], "d": meta["d"],
                                  "n": meta["n"]})
    params = {k: v for k, v in res["final_params"].items() if k != "embedding"}
    params["embedding"] = res["packed_table"]
    buffers = dict(res["buffers"], embedding={"meta": meta})
    return cfg, params, res["state"], buffers, spec, res


def build_engine(cfg, params, state, buffers, *,
                 p99_rows: int = SERVE_ROWS["serve_p99"],
                 bulk_rows: int = SERVE_ROWS["serve_bulk"],
                 device=None) -> Engine:
    """An engine with the standard cell-shape registry for one DLRM table,
    on ``device`` (the CUDA card unless the caller names another)."""
    engine = Engine(device=device)
    engine.register_packed_model(
        "dlrm", DLRM, cfg, params, state, buffers,
        shapes={"serve_p99": p99_rows, "serve_bulk": bulk_rows})
    return engine


def build_packed_dlrm(cfg, *, seed: int = 0, device=None):
    """A packed-table DLRM with random weights from ``seed`` and the Zipf
    frequency prior of ``SyntheticCTR`` over ``cfg``'s fields. Returns
    (params, buffers, state, request-stream spec)."""
    spec = CTRSpec(field_vocabs=tuple(f.vocab for f in cfg.fields), seed=seed)
    freqs = SyntheticCTR(spec).expected_frequencies()
    params, buffers, state = DLRM.init(cfg, freqs, seed=seed, device=device)
    return params, buffers, state, spec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="dlrm-criteo")
    ap.add_argument("--reduced", action="store_true",
                    help="8 fields of 1,000 ids and a (32, 16) MLP")
    ap.add_argument("--requests", type=int, default=20,
                    help="number of scoring requests to send")
    ap.add_argument("--batch", type=int, default=300,
                    help="rows per scoring request (any size; the batcher "
                         "pads/chunks onto the registered cell shapes)")
    ap.add_argument("--bulk", type=int, default=0,
                    help="also send one bulk job of this many rows")
    ap.add_argument("--p99-rows", type=int, default=SERVE_ROWS["serve_p99"])
    ap.add_argument("--bulk-rows", type=int, default=SERVE_ROWS["serve_bulk"])
    ap.add_argument("--train-steps", type=int, default=0,
                    help="serve what the MPE pipeline trains in this many "
                         "search and retrain steps on the arch's fields "
                         "(0: a random packed table from --seed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--json", default=None,
                    help="write the latency summary to this path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch(args.arch).make_config(reduced=args.reduced)
    if args.train_steps:
        cfg, params, state, buffers, spec, _ = train_packed_dlrm(
            field_vocabs=tuple(f.vocab for f in cfg.fields),
            train_steps=args.train_steps, d_embed=cfg.d_embed,
            mlp_hidden=cfg.mlp_hidden, seed=args.seed, device=device)
    else:
        params, buffers, state, spec = build_packed_dlrm(cfg, seed=args.seed,
                                                         device=device)
    ratio = Packed.storage_ratio(params["embedding"], buffers["embedding"],
                                 cfg.comp_cfg)
    print(f"[serve] {args.arch} on {device}: {cfg.comp_cfg['n']} features, "
          f"packed ratio={ratio:.4f}")
    engine = build_engine(cfg, params, state, buffers,
                          p99_rows=args.p99_rows, bulk_rows=args.bulk_rows,
                          device=device)
    req_ds = SyntheticCTR(spec._replace(batch_size=args.batch))
    for step in range(args.requests):
        engine.score(req_ds.batch(10_000 + step)["ids"])
    if args.bulk:
        engine.score(SyntheticCTR(spec._replace(batch_size=args.bulk))
                     .batch(99_999)["ids"])
    skip = min(3, max(args.requests - 1, 0))  # drop the first, cold requests
    print(engine.stats.format_table(skip_warmup=skip))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": str(device), "storage_ratio": ratio,
                       "cells": engine.stats.summary(skip_warmup=skip),
                       "counters": engine.counters()}, f, indent=2)
    return engine


if __name__ == "__main__":
    main()
