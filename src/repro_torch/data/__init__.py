"""Synthetic request streams, graphs, token streams and the prefetcher."""
from repro_torch.data.graphs import (CSRGraph, NeighborSampler,
                                     make_molecule_batch, make_sbm_graph)
from repro_torch.data.loader import Prefetcher
from repro_torch.data.synthetic import CTRSpec, SyntheticCTR
from repro_torch.data.tokens import TokenStream

__all__ = ["SyntheticCTR", "CTRSpec", "make_sbm_graph", "make_molecule_batch",
           "CSRGraph", "NeighborSampler", "TokenStream", "Prefetcher"]
