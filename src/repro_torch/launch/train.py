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
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_arch
from repro_torch.core.api import get_compressor
from repro_torch.core.mpe import MPEConfig
from repro_torch.core.pipeline import run_mpe_pipeline
from repro_torch.data.synthetic import CTRSpec, SyntheticCTR
from repro_torch.device import full_float32, resolve_device
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import adam
from repro_torch.zoo import dlrm_builder, wide_deep_builder

COMPRESSORS = ("mpe", "plain", "lsq", "alpt", "qr", "pep", "optfs")


def comp_config(compressor: str, steps: int) -> dict:
    """The reference launcher's ``comp_cfg`` of a baseline."""
    return ({"bits": 6} if compressor == "lsq" else
            {"bits": 8} if compressor == "alpt" else
            {"total_steps": steps} if compressor == "optfs" else {})


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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.compressor not in COMPRESSORS:
        raise SystemExit(f"unknown --compressor {args.compressor!r}")
    device = resolve_device(args.device)
    full_float32(device)

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
            ckpt_dir=args.ckpt_dir, prefetch=args.prefetch)
        print(f"[train] MPE ratio={res['storage_ratio']:.4f} "
              f"avg_bits={res['avg_bits']:.2f} eval={res['eval']}")
        res["cfg"] = cfg
        return res

    comp_cfg = comp_config(args.compressor, args.steps)
    bundle = build(args.seed, args.compressor, comp_cfg)
    comp = get_compressor(args.compressor)
    post = None
    if args.compressor == "alpt":
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)

        def post(params):
            comp.post_update(params["embedding"], {}, comp_cfg, gen)
            return params

    trainer = Trainer(bundle["loss_fn"], bundle["params"], bundle["buffers"],
                      bundle["state"], adam(args.lr), ckpt_dir=args.ckpt_dir,
                      post_update=post)
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
