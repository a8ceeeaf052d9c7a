"""Beyond-paper: MPE on an LM's token-embedding table, on the PyTorch port.

    PYTHONPATH=src python examples/lm_vocab_mpe_torch.py [--steps 200] [--device cpu]

Token frequencies are Zipfian like CTR features, so MPE's frequency-grouped
precision search carries over: frequent tokens keep high precision, the
long tail compresses to 1-2 bits or drops to zero. The search's lookup runs
on the ``mpe_qat`` kernels and its gathers' backward on the segment-sum
kernel on the card (their plain versions on ``--device cpu``). The twin of
``examples/lm_vocab_mpe.py``.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.mpe import MPEConfig, MPESearchEmbedding
from repro_torch.core.sampling import (average_bits, feature_bits,
                                       sample_group_bits)
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM, LMConfig
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import adam


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    vocab = 4096
    ts = TokenStream(vocab, batch=16, seq_len=64)
    mpe_cfg = MPEConfig(lam=1e-5, embed_std=0.02)
    cfg = LMConfig(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                   head_dim=32, d_ff=256, vocab=vocab,
                   compressor="mpe_search", comp_cfg=mpe_cfg._asdict(),
                   embed_std=0.02)
    gen = torch.Generator(device=device).manual_seed(0)
    params, buffers = LM.init(gen, cfg, freqs=ts.expected_frequencies())

    def loss_fn(p, bu, st, batch, *, step=None):
        loss, ce = LM.loss_fn(p, bu, batch, cfg, train=True, step=step)
        reg = MPESearchEmbedding.reg_loss(p["embedding"], bu["embedding"],
                                          mpe_cfg)
        return loss + mpe_cfg.lam * reg, (st, torch.mean(ce))

    tr = Trainer(loss_fn, params, buffers, {}, adam(1e-3))
    tr.run(lambda s: ts.batch_at(s), args.steps, log_every=50)

    gb = sample_group_bits(tr.params["embedding"], mpe_cfg)
    fb = feature_bits(gb, buffers["embedding"]["group_of_feature"])
    bits = np.asarray([0, 1, 2, 3, 4, 5, 6])[gb.cpu().numpy()]
    avg = average_bits(fb, mpe_cfg)
    print(f"\nvocab-table avg bits: {avg:.2f} (ratio {avg / 32:.4f})")
    print(f"frequent-quartile groups avg: {bits[:len(bits) // 4].mean():.2f} bits")
    print(f"rare-quartile groups avg    : {bits[-len(bits) // 4:].mean():.2f} bits")
    return tr, avg


if __name__ == "__main__":
    main()
