"""Quickstart on the PyTorch port: compress a DLRM embedding table with MPE.

    PYTHONPATH=src python examples/quickstart_torch.py [--steps 150] [--device cpu]

Runs the full paper pipeline on the card (or on ``--device``): precision
search (Eq. 8-10), sampling (Eq. 11), retraining (§3.4) and the packed
export (§4), on a synthetic Zipf CTR dataset, then scores a batch from the
bit-packed table. The twin of ``examples/quickstart.py``; ``--steps`` sets
the search and the retrain steps (150 each, as there).
"""
import argparse

import torch

from repro_torch.core.mpe import MPEConfig
from repro_torch.core.pipeline import run_mpe_pipeline
from repro_torch.data.synthetic import CTRSpec, SyntheticCTR
from repro_torch.device import resolve_device
from repro_torch.embeddings.table import FieldSpec
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.train.optimizer import adam
from repro_torch.zoo import dlrm_builder


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150,
                    help="search steps, and as many retrain steps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    spec = CTRSpec(field_vocabs=(3000, 2000, 1000, 800), batch_size=2048)
    ds = SyntheticCTR(spec)
    fields = tuple(FieldSpec(f"f{i}", v) for i, v in enumerate(spec.field_vocabs))
    cfg = DLRMConfig(fields=fields, d_embed=16, mlp_hidden=(64, 32),
                     backbone="dnn")
    build = dlrm_builder(cfg, ds.expected_frequencies(), lam=3e-5,
                         eval_batches=ds.eval_set(4), device=device)

    res = run_mpe_pipeline(
        build, lambda step: ds.batch(step), seed=0,
        mpe_cfg=MPEConfig(lam=3e-5), optimizer=adam(1e-3),
        search_steps=args.steps, retrain_steps=args.steps,
        eval_fn=build(0, "plain", {})["eval_fn"])

    print(f"\ncompression ratio : {res['storage_ratio']:.4f} "
          f"({1/res['storage_ratio']:.0f}x)")
    print(f"average bit-width : {res['avg_bits']:.2f}")
    print(f"test AUC          : {res['eval']['auc']:.4f}")
    print(f"packed bytes      : {res['packed_bytes']:,} "
          f"(fp32 table would be {sum(spec.field_vocabs)*16*4:,})")

    # serve from the packed table
    serve_cfg = cfg._replace(compressor="packed",
                             comp_cfg={"bits": res["packed_meta"]["bits"],
                                       "d": 16, "n": res["packed_meta"]["n"]})
    params = {k: v for k, v in res["final_params"].items() if k != "embedding"}
    params["embedding"] = res["packed_table"]
    buffers = dict(res["buffers"], embedding={})
    ids = torch.from_numpy(ds.batch(999)["ids"]).to(device)
    with torch.no_grad():
        logits, _, _ = DLRM.apply(params, buffers, res["state"], {"ids": ids},
                                  serve_cfg, train=False)
    print(f"served batch from packed table: {tuple(logits.shape)} logits, "
          f"mean p={float(torch.sigmoid(logits).mean()):.3f}")
    return res


if __name__ == "__main__":
    main()
