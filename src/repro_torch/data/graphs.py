"""Graph generators and a fanout neighbour sampler, on the host in numpy:
the reference's ``repro.data.graphs``, the same draws from the same seed,
so both packages see the same graphs bit for bit (``make_sbm_graph`` finds
each class's edges by one sort where the reference makes a pass a class).

``make_sbm_graph`` plants community structure (stochastic block model) so GIN
has learnable signal on the node-classification cells. ``NeighborSampler``
implements GraphSAGE-style layered fanout sampling over CSR adjacency with
static output shapes (padded) — the minibatch_lg requirement.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class CSRGraph(NamedTuple):
    indptr: np.ndarray     # (N+1,)
    indices: np.ndarray    # (E,) neighbor ids
    n_nodes: int


def csr_from_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> CSRGraph:
    order = np.argsort(dst, kind="stable")
    src_sorted = src[order]
    counts = np.bincount(dst, minlength=n_nodes)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return CSRGraph(indptr=indptr, indices=src_sorted.astype(np.int64), n_nodes=n_nodes)


def make_sbm_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int,
                   seed: int = 0, homophily: float = 0.8):
    """Stochastic-block-model graph with class-correlated features."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes)
    same = rng.random(n_edges) < homophily
    src = rng.integers(0, n_nodes, n_edges)
    # homophilous edges pick a destination with the same label
    by_class = [np.nonzero(labels == c)[0] for c in range(n_classes)]
    dst = rng.integers(0, n_nodes, n_edges)
    # each class's homophilous edges, in increasing edge order, from one
    # stable sort of the edges by their source's class (-1: not homophilous)
    # rather than one pass over all edges a class: the same edges and the
    # same draws, in the same order, as the reference's loop; int16 keys
    # (numpy radix-sorts them) hold up to 32,767 classes
    if n_classes > np.iinfo(np.int16).max:
        raise ValueError(f"n_classes {n_classes} above {np.iinfo(np.int16).max}")
    lab = np.where(same, labels[src], -1).astype(np.int16)
    order = np.argsort(lab, kind="stable")
    bounds = np.cumsum(np.bincount(lab.astype(np.int64) + 1,
                                   minlength=n_classes + 1))
    for c in range(n_classes):
        sel = order[bounds[c]:bounds[c + 1]]
        if sel.size and len(by_class[c]):
            dst[sel] = rng.choice(by_class[c], sel.size)
    centers = rng.normal(0, 1.0, (n_classes, d_feat)).astype(np.float32)
    x = centers[labels] + rng.normal(0, 2.0, (n_nodes, d_feat)).astype(np.float32)
    return {
        "x": x, "edge_src": src.astype(np.int32), "edge_dst": dst.astype(np.int32),
        "labels": labels.astype(np.int32), "n_nodes": n_nodes,
    }


def make_molecule_batch(batch: int, n_nodes: int, n_edges: int,
                        atom_vocab: int = 119, n_classes: int = 2, seed: int = 0):
    """Batched small graphs (block-diagonal edge list), categorical atoms.

    Planted rule: label = presence of an atom-type above a threshold count —
    learnable, and dependent on the atom embedding (MPE's categorical case).
    """
    rng = np.random.default_rng(seed)
    atoms = rng.integers(0, atom_vocab, (batch, n_nodes)).astype(np.int32)
    src = rng.integers(0, n_nodes, (batch, n_edges))
    dst = rng.integers(0, n_nodes, (batch, n_edges))
    offs = (np.arange(batch) * n_nodes)[:, None]
    labels = ((atoms < atom_vocab // 8).sum(axis=1) > n_nodes // 8).astype(np.int32)
    return {
        "atom_ids": atoms.reshape(-1),
        "edge_src": (src + offs).reshape(-1).astype(np.int32),
        "edge_dst": (dst + offs).reshape(-1).astype(np.int32),
        "graph_ids": np.repeat(np.arange(batch), n_nodes).astype(np.int32),
        "n_graphs": batch,
        "labels": labels,
    }


def pad_graph_edges(graph: dict, multiple: int = 512) -> dict:
    """Pad the edge list (and mask) so edge shards divide the mesh evenly.

    Padded edges point node 0 -> node 0 with edge_mask=False, so message
    passing ignores them exactly.
    """
    e = graph["edge_src"].shape[0]
    target = -(-e // multiple) * multiple
    if target == e and "edge_mask" in graph:
        return graph
    pad = target - e
    out = dict(graph)
    mask = graph.get("edge_mask", np.ones((e,), bool))
    out["edge_src"] = np.concatenate([graph["edge_src"],
                                      np.zeros((pad,), graph["edge_src"].dtype)])
    out["edge_dst"] = np.concatenate([graph["edge_dst"],
                                      np.zeros((pad,), graph["edge_dst"].dtype)])
    out["edge_mask"] = np.concatenate([mask, np.zeros((pad,), bool)])
    return out


class NeighborSampler:
    """Layered uniform fanout sampling with static (padded) output shapes."""

    def __init__(self, graph: CSRGraph, fanouts: tuple, seed: int = 0):
        self.g = graph
        self.fanouts = fanouts
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray):
        """seeds: (B,) -> dict with padded nodes/edges for all hops.

        Output nodes: [seeds, hop1 samples, hop2 samples, ...] with fixed
        sizes B, B*f1, B*f1*f2, ... (duplicates allowed — GraphSAGE style);
        edges connect each sampled neighbor to its parent.
        """
        g = self.g
        frontier = seeds.astype(np.int64)
        all_nodes = [frontier]
        src_list, dst_list, mask_list = [], [], []
        node_offset = 0
        for f in self.fanouts:
            deg = g.indptr[frontier + 1] - g.indptr[frontier]
            # uniform sample f neighbors per frontier node (with replacement)
            r = self.rng.integers(0, 2**63 - 1, (frontier.shape[0], f))
            idx = np.where(deg[:, None] > 0, r % np.maximum(deg, 1)[:, None], 0)
            nbrs = g.indices[g.indptr[frontier][:, None] + idx]      # (Bf, f)
            valid = np.broadcast_to(deg[:, None] > 0, (frontier.shape[0], f))
            child_offset = node_offset + frontier.shape[0]
            # edge: sampled neighbor (child, message src) -> parent (dst)
            parents = node_offset + np.arange(frontier.shape[0])
            src_list.append((child_offset + np.arange(nbrs.size)).astype(np.int64))
            dst_list.append(np.repeat(parents, f))
            mask_list.append(valid.reshape(-1))
            frontier = nbrs.reshape(-1)
            all_nodes.append(frontier)
            node_offset = child_offset
        nodes = np.concatenate(all_nodes)
        return {
            "node_ids": nodes.astype(np.int64),          # global ids to fetch feats
            "edge_src": np.concatenate(src_list).astype(np.int32),
            "edge_dst": np.concatenate(dst_list).astype(np.int32),
            "edge_mask": np.concatenate(mask_list),
            "n_seeds": int(seeds.shape[0]),
        }

    @staticmethod
    def output_sizes(batch: int, fanouts: tuple):
        """Static node/edge counts for dry-run specs."""
        nodes, edges, b = batch, 0, batch
        for f in fanouts:
            edges += b * f
            b *= f
            nodes += b
        return nodes, edges
