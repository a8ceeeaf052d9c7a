"""Serving launcher: score a synthetic CTR request stream from a packed table.

Builds a DLRM whose embedding is the bit-packed mixed-precision table of
paper §4, the way the reference's ``Packed.init`` does (the search layer's
init, random γ scaled by 0.01, Eq. 11 sampling, the packed export) with
weights drawn from ``--seed`` and the Zipf frequency prior of
``SyntheticCTR``. It registers the ``serve_p99`` and ``serve_bulk`` cells,
sends ``--requests`` requests of ``--batch`` rows (padded onto the p99
cell) and optionally one ``--bulk`` job, and prints per-cell p50/p99 latency
in the Figure-5 lookup-vs-compute split.

Runs on the CUDA card unless ``--device`` names another:

    python -m repro_torch.launch.serve --arch dlrm-criteo --requests 20 --batch 300 --bulk 300000
    python -m repro_torch.launch.serve --arch dlrm-criteo --reduced --device cpu
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs.base import SERVE_ROWS, get_arch
from repro_torch.core.compressors import Packed
from repro_torch.data.synthetic import CTRSpec, SyntheticCTR
from repro_torch.device import resolve_device
from repro_torch.models.dlrm import DLRM
from repro_torch.serve.engine import Engine


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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--json", default=None,
                    help="write the latency summary to this path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_arch(args.arch).make_config(reduced=args.reduced)
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
