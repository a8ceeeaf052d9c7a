"""MPE on GIN's categorical atom-type embedding (the molecule cell), on the
PyTorch port.

    PYTHONPATH=src python examples/gnn_molecule_mpe_torch.py [--steps 150] [--device cpu]

GIN's message passing and pooling run on the segment-sum kernel on the
card (or its plain version on ``--device cpu``). The twin of
``examples/gnn_molecule_mpe.py``.
"""
import argparse

import numpy as np

from repro_torch.core.mpe import MPEConfig
from repro_torch.core.sampling import (average_bits, feature_bits,
                                       sample_group_bits)
from repro_torch.data.graphs import make_molecule_batch
from repro_torch.device import resolve_device
from repro_torch.models.gnn import GIN, GINConfig
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import adam


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    mpe_cfg = MPEConfig(lam=3e-5, group_size=16)  # small vocab -> small groups
    cfg = GINConfig(n_layers=3, d_hidden=32, input_mode="categorical",
                    atom_vocab=119, readout="graph", n_classes=2,
                    compressor="mpe_search", comp_cfg=mpe_cfg._asdict())
    # atom frequencies are Zipf-ish in real molecule corpora
    freqs = (np.arange(1, 120) ** -1.1)
    params, buffers = GIN.init(cfg, freqs=freqs, seed=0, device=device)

    n_graphs = 64

    def data_fn(step):
        b = make_molecule_batch(n_graphs, 12, 24, atom_vocab=119, seed=step)
        b.pop("n_graphs")  # static: injected below
        return b

    def loss_fn(p, bu, st, batch, *, step=None):
        graph = dict(batch, n_graphs=n_graphs)
        loss, ce = GIN.loss_fn(p, bu, graph, cfg, lam=mpe_cfg.lam, train=True,
                               step=step)
        return loss, (st, ce)

    tr = Trainer(loss_fn, params, buffers, {}, adam(3e-3))
    tr.run(data_fn, args.steps, log_every=50)

    gb = sample_group_bits(tr.params["embedding"], mpe_cfg)
    fb = feature_bits(gb, buffers["embedding"]["group_of_feature"])
    bits = average_bits(fb, mpe_cfg)
    print(f"\natom-table avg bits: {bits:.2f} (ratio {bits/32:.4f})")
    return tr, bits


if __name__ == "__main__":
    main()
