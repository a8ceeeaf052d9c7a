"""Memory-bounded attention for long sequences: the reference's
``chunked_gqa_attention`` (``repro/nn/chunked.py``), blockwise
(flash-style) attention in plain PyTorch — an online softmax over KV
chunks for each Q chunk, so the materialized score block is
(q_chunk × kv_chunk) instead of (S × T).

In the port it is the plain version of the long-sequence route, which runs
on ``kernels/flash_attention``'s tiled kernel: what the kernel is held
against at lengths where the whole (S × T) score matrix does not fit.

``chunked_softmax_xent`` is the reference's cross-entropy over sequence
chunks for big-vocabulary LM heads: one ``torch.autograd.Function`` that
keeps no (B, chunk, V) block from one chunk to the next. Its backward
recomputes each chunk's logits and adds its share to dx and d``lm_head``,
as the reference's ``jax.checkpoint`` on the chunk body does.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def chunked_gqa_attention(q, k, v, *, n_kv_heads: int, causal: bool,
                          q_offset=0, kv_valid_len=None,
                          q_chunk: int = 512, kv_chunk: int = 1024,
                          expand_kv: bool = False,
                          block_dtype=None) -> torch.Tensor:
    """q: (B,S,Hq,hd); k,v: (B,T,Hkv,hd) -> (B,S,Hq,hd). fp32 softmax.

    ``expand_kv`` repeats K/V up to the query-head count (the reference
    does so to shard heads over a mesh; on one device it changes only the
    layout). ``block_dtype`` (e.g. ``torch.bfloat16``) rounds the blocks
    to that type before each product, which accumulates in float32."""
    b, s, hq, hd = q.shape
    t = k.shape[1]
    if expand_kv and hq != n_kv_heads:
        rep = hq // n_kv_heads
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
        n_kv_heads = hq
    group = hq // n_kv_heads
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, t)
    nq, nk = s // q_chunk, t // kv_chunk
    if s % q_chunk or t % kv_chunk:
        raise ValueError(f"chunks ({q_chunk}, {kv_chunk}) must divide "
                         f"(S, T) = ({s}, {t})")

    scale = hd ** -0.5
    bd = block_dtype or torch.float32

    def block(x):   # rounded to the block dtype, multiplied in float32
        return x.to(bd).to(torch.float32)

    qr = block(q.reshape(b, nq, q_chunk, n_kv_heads, group, hd))
    kr = block(k.reshape(b, nk, kv_chunk, n_kv_heads, hd))
    vr = block(v.reshape(b, nk, kv_chunk, n_kv_heads, hd))
    dev = q.device
    outs = []
    for qi in range(nq):
        qb = qr[:, qi]
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        acc = torch.zeros((b, n_kv_heads, group, q_chunk, hd),
                          dtype=torch.float32, device=dev)
        m = torch.full((b, n_kv_heads, group, q_chunk), NEG_INF,
                       dtype=torch.float32, device=dev)
        denom = torch.zeros_like(m)
        for ki in range(nk):
            k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            logits = torch.einsum("bqkgh,bckh->bkgqc", qb, kr[:, ki]) * scale
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            if kv_valid_len is not None:
                mask &= (k_pos < kv_valid_len)[None, :]
            logits = torch.where(mask, logits, NEG_INF)
            new_m = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - new_m)
            p = torch.exp(logits - new_m[..., None])
            denom = denom * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqc,bckh->bkgqh", block(p), vr[:, ki])
            m = new_m
        out = acc / torch.clamp_min(denom[..., None], 1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))            # (b, qc, kv, g, hd)
    out = torch.stack(outs, dim=1).reshape(b, s, hq, hd)
    return out.to(q.dtype)


class _ChunkedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lm_head, labels, chunk):
        b, s, d = x.shape
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for lo in range(0, s, chunk):
            xc = x[:, lo:lo + chunk].reshape(-1, d)
            logits = xc @ lm_head
            logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            del logits
            lc = labels[:, lo:lo + chunk].reshape(-1, 1).long()
            tot = tot - logp.gather(-1, lc).sum()
            del logp
        ctx.save_for_backward(x, lm_head, labels)
        ctx.chunk = chunk
        return tot / (b * s)

    @staticmethod
    def backward(ctx, g):
        x, lm_head, labels = ctx.saved_tensors
        chunk = ctx.chunk
        b, s, d = x.shape
        gt = g.to(torch.float32) / (b * s)        # each token's ce cotangent
        dx = torch.empty_like(x)
        dw = torch.zeros(lm_head.shape, dtype=torch.float32,
                         device=lm_head.device)
        for lo in range(0, s, chunk):
            xc = x[:, lo:lo + chunk].reshape(-1, d)
            lc = labels[:, lo:lo + chunk].reshape(-1)
            logits = xc @ lm_head
            # d/dlogits of -logp[label]: softmax - onehot, in float32, then
            # the cast's backward to the logits' type
            dl = torch.softmax(logits.to(torch.float32), dim=-1)
            del logits
            rows = torch.arange(dl.shape[0], device=dl.device)
            dl[rows, lc] -= 1.0
            dl = dl.mul_(gt).to(lm_head.dtype)
            dx[:, lo:lo + chunk] = (dl @ lm_head.T).reshape(b, -1, d)
            dw += (xc.T @ dl).to(torch.float32)
            del dl
        return dx, dw.to(lm_head.dtype), None, None


def chunked_softmax_xent(x, lm_head, labels, *,
                         chunk: int = 512) -> torch.Tensor:
    """x (B, S, d) final hidden states, lm_head (d, V), labels (B, S) ->
    the mean cross-entropy, a 0-d float32 tensor.

    The sequence is taken ``chunk`` positions at a time (``min(chunk, S)``,
    which must divide S): logits ``xc @ lm_head`` in the model's type, the
    log-softmax in float32. The backward recomputes each chunk's logits;
    d``lm_head`` is summed over the chunks in float32 and rounded to its
    type once (the reference's scan carries it in that type)."""
    b, s, d = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"chunk {chunk} must divide S = {s}")
    return _ChunkedXent.apply(x, lm_head, labels, chunk)
