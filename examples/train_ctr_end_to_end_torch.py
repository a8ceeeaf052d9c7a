"""End-to-end run on the PyTorch port: train a ~100M-parameter CTR model
with the full MPE pipeline, checkpoints and the packed export.

    PYTHONPATH=src python examples/train_ctr_end_to_end_torch.py [--steps 250] [--device cpu]

Model: DNN backbone, 8 fields / 6.3 M features × d = 16 ≈ 101 M embedding
parameters + the 1024-512-256 MLP (the paper's interaction net), on the
card unless ``--device`` names another. The twin of
``examples/train_ctr_end_to_end.py``. On a mesh of ranks (``repro_torch.dist``,
under ``torch.distributed.run``) the same pipeline takes
``run_mpe_pipeline(..., mesh=parse_mesh_flag("dp,mp"))``.
"""
import argparse
import tempfile

from repro_torch.core.mpe import MPEConfig
from repro_torch.core.pipeline import run_mpe_pipeline
from repro_torch.data.synthetic import CTRSpec, SyntheticCTR
from repro_torch.device import resolve_device
from repro_torch.embeddings.table import FieldSpec
from repro_torch.models.dlrm import DLRMConfig
from repro_torch.nn.module import param_count
from repro_torch.train.optimizer import adam
from repro_torch.zoo import dlrm_builder

VOCABS = (2_097_152, 1_048_576, 1_048_576, 786_432, 524_288, 524_288,
          262_144, 16_384)  # 6.3M features


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="mpe_ckpt_")

    ds = SyntheticCTR(CTRSpec(field_vocabs=VOCABS, batch_size=args.batch))
    fields = tuple(FieldSpec(f"f{i}", v) for i, v in enumerate(VOCABS))
    cfg = DLRMConfig(fields=fields, d_embed=16,
                     mlp_hidden=(1024, 512, 256), backbone="dnn")
    build = dlrm_builder(cfg, ds.expected_frequencies(), lam=1e-5,
                         eval_batches=ds.eval_set(2), device=device)

    probe = build(0, "plain", {})
    print(f"model size: {param_count(probe['params'])/1e6:.1f}M params "
          f"({sum(VOCABS)*16/1e6:.0f}M embedding)")
    eval_fn = probe["eval_fn"]
    del probe

    res = run_mpe_pipeline(
        build, lambda step: ds.batch(step), seed=0,
        mpe_cfg=MPEConfig(lam=1e-5), optimizer=adam(1e-3),
        search_steps=args.steps, retrain_steps=args.steps,
        eval_fn=eval_fn, ckpt_dir=ckpt)
    print(f"\nMPE on {sum(VOCABS)*16/1e6:.0f}M-param table: "
          f"ratio={res['storage_ratio']:.4f} "
          f"({1/max(res['storage_ratio'],1e-9):.0f}x), "
          f"avg_bits={res['avg_bits']:.2f}, eval={res['eval']}")
    print(f"checkpoints in {ckpt} (resume by re-running with --ckpt-dir)")
    return res


if __name__ == "__main__":
    main()
