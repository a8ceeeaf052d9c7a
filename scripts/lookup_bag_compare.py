#!/usr/bin/env python3
"""Time one checkout's packed lookup and embedding bag, and the serving
requests that run the lookup, on one CUDA card, so that two checkouts can
be compared by running the script on each in turns in one call
(parent, change, change, parent).

    python3 scripts/lookup_bag_compare.py [--src DIR] [--json OUT]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (its
kernels are built there at first use; the default is this checkout's). The
tables, ids and helpers are ``chip_smoke.py``'s, from this checkout, made
from the same seeds, so both checkouts see the same inputs:

- the lookup, warm (back-to-back calls on the same ids) and cold (each
  launch timed alone after a 256 MB write), at DLRM's ``serve_p99`` (19,968 ids)
  and ``serve_bulk`` (10,223,616 ids) on the full-width table made by
  ``build_packed_dlrm``; SASRec's bulk encode (262,144 x 50) and
  ``retrieval_cand`` candidates (1,048,576) and BST's bulk apply (262,144 x
  21 item ids and 262,144 x 4 context ids) on random packed tables made as
  ``chip_smoke.py`` makes them; the warm ``serve_p99`` time is the
  wrapper's whole call, which is bound by the host;
- the bag's forward, backward and forward plus backward through autograd
  over the 17,039,360 x 32 BST table (random weights) with Zipf(1.1) bags
  of 20 at 65,536 (``train_batch``) and 262,144 (``serve_bulk``) bags and
  ragged masks, beside ``F.embedding_bag`` (forward, and forward plus
  backward);
- request times, host clock to a synchronize: DLRM's engine at requests of
  1, 300 and 512 rows (p50 of 60) and one of 300,000 rows, the SASRec bulk
  encode, BST's ``serve_bulk`` and ``retrieval_cand`` applies (p50 of 5
  each).

Prints one JSON object, the card's name and power limit in it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--src", default=os.path.join(ROOT, "src"))
ap.add_argument("--json", default=None)


def main() -> int:
    args = ap.parse_args()
    # the timed checkout's repro_torch first: chip_smoke's own imports of
    # repro_torch then resolve inside that package
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch
    import repro_torch  # noqa: F401
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    assert repro_torch.__file__.startswith(os.path.abspath(args.src))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"src": args.src, "card": smi, "lookup": {}, "bag": {},
           "requests": {}}
    t_start = time.perf_counter()

    # DLRM: the full-width table, the cells' ids, the engine's requests
    cfg = cs.get_arch("dlrm-criteo").make_config(backbone="dnn")
    params, buffers, state, spec = cs.build_packed_dlrm(cfg, seed=cs.SEED,
                                                        device=dev)
    table, meta = params["embedding"], buffers["embedding"]["meta"]
    for shape, rows in cs.SERVE_ROWS.items():
        gids = cs.request_gids(spec, buffers, rows, 5_000, dev)
        out["lookup"][f"dlrm {shape}"] = cs.time_lookup(table, meta, gids,
                                                        f"dlrm {shape}")
    engine = cs.build_engine(cfg, params, state, buffers, device=dev)
    engine.score(cs.SyntheticCTR(spec._replace(batch_size=8)).batch(1)["ids"])
    engine.score(cs.SyntheticCTR(spec._replace(batch_size=600)).batch(2)["ids"])
    small = [cs.SyntheticCTR(spec._replace(batch_size=rows)).batch(step)["ids"]
             for step, rows in enumerate(cs.REQUEST_ROWS * 20, start=10_000)]
    bulk = cs.SyntheticCTR(spec._replace(batch_size=cs.BULK_ROWS)).batch(
        10_015)["ids"]
    p99_ms = [cs.time_requests(lambda x=ids: engine.score(x), 1)[0]
              for ids in small]
    out["requests"]["dlrm request p50 (<=512 rows)"] = float(
        np.percentile(p99_ms, 50))
    out["requests"]["dlrm bulk request (300,000 rows)"] = float(np.median(
        cs.time_requests(lambda: engine.score(bulk), 5)))
    del params, buffers, state, table, engine

    # SASRec: a random packed table, the bulk encode and the candidates
    scfg_src = cs.get_arch("sasrec").make_config()
    freqs = cs.zipf_prior(scfg_src.item_vocab)
    scfg = cs.serve_cfg(scfg_src, scfg_src.item_vocab)
    params, buffers, _ = cs.SASRec.init(scfg, freqs, seed=cs.SEED, device=dev)
    rng = np.random.default_rng(cs.SEED)
    cdf = np.cumsum(freqs)
    seq = torch.from_numpy(cs.zipf_ids(rng, cdf, (cs.SERVE_ROWS["serve_bulk"],
                                                  scfg.seq_len))).to(dev)
    cand = torch.from_numpy(rng.choice(scfg.item_vocab, cs.N_CANDIDATES,
                                       replace=False).astype(np.int32)).to(dev)
    table, meta = params["embedding"], buffers["embedding"]["meta"]
    out["lookup"]["sasrec serve_bulk encode"] = cs.time_lookup(
        table, meta, seq, "sasrec serve_bulk encode")
    out["lookup"]["sasrec retrieval_cand candidates"] = cs.time_lookup(
        table, meta, cand, "sasrec retrieval_cand candidates")
    with torch.inference_mode():
        out["requests"]["sasrec bulk encode (262,144)"] = float(np.median(
            cs.time_requests(lambda: cs.SASRec.encode(params, buffers, seq,
                                                      scfg), 5)))
    del params, buffers, table, seq, cand

    # BST: a random packed table, the bulk apply's two lookups, the cells
    bcfg = cs.get_arch("bst").make_config()
    prior = cs.bst_prior(bcfg)
    n = cs.total_vocab(cs.fields(bcfg))
    bscfg = cs.serve_cfg(bcfg, n)
    params, buffers, state = cs.BST.init(bscfg, prior["freqs"], seed=cs.SEED,
                                         device=dev)
    rng = np.random.default_rng(cs.SEED + 3)
    table, meta = params["embedding"], buffers["embedding"]["meta"]
    for shape in ("serve_bulk", "retrieval_cand"):
        one = shape == "retrieval_cand"
        rows = cs.N_CANDIDATES if one else cs.SERVE_ROWS[shape]
        batch = cs.bst_batch(rng, prior["cdf"], bscfg, rows, dev,
                             one_history=one)
        if not one:
            items = torch.cat([batch["seq_ids"], batch["target_id"][:, None]],
                              dim=1) + buffers["item_offset"]
            ctx = batch["ctx_ids"] + buffers["ctx_offsets"][None, :]
            out["lookup"]["bst serve_bulk items"] = cs.time_lookup(
                table, meta, items, "bst serve_bulk items")
            out["lookup"]["bst serve_bulk context"] = cs.time_lookup(
                table, meta, ctx, "bst serve_bulk context")

        def request(b=batch, one=one):
            logits = cs.BST.apply(params, buffers, state, b, bscfg)[0]
            return torch.topk(logits, cs.TOP_K) if one else logits
        with torch.inference_mode():
            out["requests"][f"bst {shape} ({rows})"] = float(np.median(
                cs.time_requests(request, 5)))
        del batch
    del params, buffers, state, table

    # the bag over the BST table's size
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    table = torch.randn((n, bcfg.d_embed), generator=gen, device=dev)
    rng = np.random.default_rng(cs.SEED + 4)
    l = bcfg.seq_len
    for shape, bags in (("train_batch", cs.TRAIN_ROWS),
                        ("serve_bulk", cs.SERVE_ROWS["serve_bulk"])):
        ids = torch.from_numpy(cs.zipf_ids(rng, prior["cdf"], (bags, l))).to(dev)
        mask = torch.from_numpy(np.arange(l)[None, :] < rng.integers(
            1, l + 1, (bags, 1))).to(dev)
        g = torch.randn((bags, bcfg.d_embed), generator=gen, device=dev)
        weights = mask.to(torch.float32)
        port_leaf = table.detach().requires_grad_(True)
        lib_leaf = table.detach().requires_grad_(True)
        bag_ops = cs.bag_ops
        work = cs.bag_work(table, ids, mask)
        row = {**work,
               "fwd_ms": cs.cuda_ms(lambda: bag_ops.embedding_bag_fwd(
                   table, ids, mask), 50),
               "fwd_library_ms": cs.cuda_ms(lambda: torch.nn.functional
                                            .embedding_bag(
                                                ids, table, mode="sum",
                                                per_sample_weights=weights),
                                            50),
               "bwd_ms": cs.cuda_ms(lambda: bag_ops.embedding_bag_bwd(
                   g, ids, mask, n), 10),
               "fwd_bwd_ms": cs.cuda_ms(lambda: torch.autograd.grad(
                   bag_ops.embedding_bag_kernel(port_leaf, ids, mask),
                   port_leaf, g), 10),
               "fwd_bwd_library_ms": cs.cuda_ms(lambda: torch.autograd.grad(
                   torch.nn.functional.embedding_bag(
                       ids, lib_leaf, mode="sum", per_sample_weights=weights),
                   lib_leaf, g), 10)}
        out["bag"][shape] = row
        cs.log(f"bag at {shape}: " + json.dumps(row))
        del port_leaf, lib_leaf, ids, mask, g, weights
    out["seconds"] = time.perf_counter() - t_start
    text = json.dumps(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
