"""Training launcher: the MPE pipeline (search → sample → retrain → packed
export) on a synthetic CTR stream, or a plain full-precision DLRM.

Runs on the CUDA card unless ``--device`` names another; on the card, float32
matrix products and convolutions run in full float32 (TF32 off), as the
reference trains.

    python -m repro_torch.launch.train --arch dlrm-criteo --batch 65536 --steps 8 --retrain-steps 8
    python -m repro_torch.launch.train --reduced --device cpu --steps 50
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import get_arch
from repro_torch.core.api import get_compressor
from repro_torch.core.mpe import MPEConfig
from repro_torch.core.pipeline import run_mpe_pipeline
from repro_torch.data.synthetic import CTRSpec, SyntheticCTR
from repro_torch.device import full_float32, resolve_device
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import adam
from repro_torch.zoo import dlrm_builder

# compressors of the reference's launcher that the paper-baselines slice brings
_BASELINES = ("lsq", "alpt", "qr", "pep", "optfs")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="dlrm-criteo")
    ap.add_argument("--backbone", default="dnn", help="dnn | dcn | deepfm | ipnn")
    ap.add_argument("--compressor", default="mpe", help="mpe | plain")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--retrain-steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--lam", type=float, default=3e-5)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="8 fields of 1,000 ids and a (32, 16) MLP")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.compressor in _BASELINES:
        raise SystemExit(f"--compressor {args.compressor} comes with the "
                         f"port's paper-baselines slice")
    if args.compressor not in ("mpe", "plain"):
        raise SystemExit(f"unknown --compressor {args.compressor!r}")
    device = resolve_device(args.device)
    full_float32(device)

    cfg = get_arch(args.arch).make_config(args.reduced, backbone=args.backbone)
    ds = SyntheticCTR(CTRSpec(field_vocabs=tuple(f.vocab for f in cfg.fields),
                              batch_size=args.batch, seed=args.seed))
    eval_batches = ds.eval_set(4)
    build = dlrm_builder(cfg, ds.expected_frequencies(), lam=args.lam,
                         eval_batches=eval_batches, device=device)
    print(f"[train] {args.arch} ({args.backbone}) on {device}: "
          f"{len(cfg.fields)} fields, batch {args.batch}")

    if args.compressor == "mpe":
        res = run_mpe_pipeline(
            build, ds.batch, seed=args.seed, mpe_cfg=MPEConfig(lam=args.lam),
            optimizer=adam(args.lr), search_steps=args.steps,
            retrain_steps=args.retrain_steps or args.steps,
            eval_fn=build(args.seed, "plain", {})["eval_fn"])
        print(f"[train] MPE ratio={res['storage_ratio']:.4f} "
              f"avg_bits={res['avg_bits']:.2f} eval={res['eval']}")
        res["cfg"] = cfg
        return res

    bundle = build(args.seed, "plain", {})
    trainer = Trainer(bundle["loss_fn"], bundle["params"], bundle["buffers"],
                      bundle["state"], adam(args.lr))
    trainer.run(ds.batch, args.steps)
    ev = bundle["eval_fn"](trainer.params, bundle["buffers"], trainer.state)
    r = get_compressor("plain").storage_ratio(trainer.params["embedding"],
                                              bundle["buffers"]["embedding"], {})
    print(f"[train] plain ratio={r:.4f} eval={ev}")
    return {"params": trainer.params, "state": trainer.state,
            "buffers": bundle["buffers"], "history": trainer.history,
            "eval": ev, "storage_ratio": r, "cfg": bundle["cfg"]}


if __name__ == "__main__":
    main()
