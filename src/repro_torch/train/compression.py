"""Gradient compression for a cross-pod all-reduce, as the reference has it:
int8 quantization with error feedback (the residual of each quantization is
carried into the next step, so the compressed series telescopes to the true
gradient sum), and row-sparse embedding gradients (only the touched rows
are shipped, as (row_idx, values)).

Every operation is the reference's in float32; ``torch.round`` rounds half
to even, as ``jnp.round`` does. The ``Trainer`` applies the error-feedback
transform after the global-norm clip (``grad_compression=True``).
"""
from __future__ import annotations

import torch

from repro_torch.train.tree import leaves, tree_map, unflatten


def int8_compress(g: torch.Tensor, err: torch.Tensor):
    """Quantize g + err to int8 with a per-tensor scale. Returns
    (q, scale, new_err)."""
    target = g + err
    scale = torch.amax(torch.abs(target)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, target - deq


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def make_error_feedback_transform():
    """A stateful gradient transform over a tree of residuals that the
    caller threads through the steps:

        init, apply = make_error_feedback_transform()
        ef_state = init(grads_template)
        grads, ef_state = apply(grads, ef_state)
    """
    def init(grads_template):
        return tree_map(torch.zeros_like, grads_template)

    def apply(grads, ef_state):
        new_grads, new_state = [], []
        for g, e in zip(leaves(grads), leaves(ef_state)):
            q, s, new_e = int8_compress(g, e)
            new_grads.append(int8_decompress(q, s))
            new_state.append(new_e)
        return unflatten(grads, new_grads), unflatten(ef_state, new_state)

    return init, apply


def rowsparse_compress(grad_table: torch.Tensor, touched_rows: torch.Tensor):
    """Embedding-table gradients: ship only the touched rows (idx, values)."""
    return touched_rows, grad_table[touched_rows.long()]


def rowsparse_decompress(n_rows: int, idx: torch.Tensor,
                         vals: torch.Tensor) -> torch.Tensor:
    """The dense (n_rows, d) table gradient, duplicates added in float32."""
    out = torch.zeros((n_rows, vals.shape[-1]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, idx.long(), vals)
