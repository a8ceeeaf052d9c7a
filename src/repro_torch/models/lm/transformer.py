"""Decoder-only LM covering every transformer architecture, as the
reference's ``repro/models/lm/transformer.py`` defines it.

One config class expresses: starcoder2-7b (GQA kv=4, RoPE), qwen3-32b
(GQA kv=8, qk_norm), internlm2-1.8b (GQA kv=8), deepseek-moe-16b (2 shared +
64 routed top-6 fine-grained MoE), grok-1-314b (8 experts top-2). The token
embedding is a pluggable compressor table: MPE applies to the Zipfian
vocabulary as to CTR features, and the ``packed`` table serves it through
``kernels/mpe_lookup``.

Layers stay stacked — every leaf of ``params["layers"]`` has a leading
(L,) axis, as the reference's scan wants them, so weights carry leaf for
leaf — and are walked with a Python loop.

Attention: without a cache, causal attention over the sequence runs on
``kernels/flash_attention`` (the tiled kernel at S > 64) in float32, the
sequence right-padded to the kernel's blocks of 128 (exact under the
causal mask). With caches, each layer's new keys and values go into its
caches in place, both in one call (``kernels/kv_cache_write``'s
``kv_cache_write_kv``, one launch at decode, which keeps the int8 caches'
running-absmax scales without a host sync), and

  - a prefill into an empty cache (one shared length 0, S > 1) attends
    over the first S cache rows — dequantized, as the reference attends
    over the dequantized cache — on the flash kernel: with offset 0 and S
    valid keys that is causal attention over those rows;
  - every other step (decode, a continued prefill, per-row lengths) runs
    ``kernels/decode_attention`` over the cache.

Decode caches: {"k", "v": (L, B, T_max, n_kv, hd), "len": () or (B,)[,
"k_scale", "v_scale": (L, B, 1, n_kv, 1)]}. The port writes k, v and the
scales in place and returns the same tensors with a new length, where the
reference returns new arrays: the caches passed in are the caches returned.

``shard_activations``, ``seq_shard_attn``, ``attn_expand_kv`` and
``attn_block_bf16`` place or round work on a mesh; on one device the
reference leaves the first three without effect, and the port reads all
four and leaves them so (the flash kernel computes in float32, as the
reference's chunked route does without ``attn_block_bf16``, which is every
config). ``remat`` matters to the training path only: where it is set,
no caches are passed and grad is enabled, each layer runs under
``torch.utils.checkpoint`` (non-reentrant), so the backward keeps only each
layer's input and recomputes the layer, as the reference's
``jax.checkpoint`` on its scan body does.

Training: ``loss_fn`` is the reference's next-token cross-entropy plus
``aux_weight`` times the MoE's load-balance loss, through the whole logit
matrix, or with ``cfg.ce_chunk`` set through ``hidden_states`` and
``nn/chunked.py::chunked_softmax_xent``, which never holds more than one
chunk's (B, chunk, V) logits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.api import get_compressor
from repro_torch.core.quantizer import dequantize_symmetric
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import BLOCK, flash_attention
from repro_torch.kernels.kv_cache_write.ops import (kv_cache_write,
                                                    kv_cache_write_kv)
from repro_torch.nn import init as initializers
from repro_torch.nn.attention import MHA
from repro_torch.nn.chunked import chunked_softmax_xent
from repro_torch.nn.linear import Dense
from repro_torch.nn.moe import MoE, MoEConfig
from repro_torch.nn.norms import RMSNorm
from repro_torch.nn.rope import apply_rope
from repro_torch.train.tree import tree_map

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class LMConfig(NamedTuple):
    name: str = "lm"
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 512
    vocab: int = 1024
    qk_norm: bool = False
    rope_theta: float = 10000.0
    moe: MoEConfig | None = None      # None => dense SwiGLU FFN
    dtype: str = "float32"            # param/activation dtype
    remat: bool = True
    compressor: str = "plain"
    comp_cfg: dict | None = None
    embed_std: float = 0.02
    attn_chunk_q: int = 0             # the reference's chunked route
    attn_chunk_kv: int = 1024
    ce_chunk: int = 0
    seq_shard_attn: bool = False      # mesh-only
    shard_activations: bool = False   # mesh-only
    attn_expand_kv: bool = False      # mesh-only
    attn_block_bf16: bool = False


def _dt(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _comp_cfg(cfg) -> dict:
    ccfg = dict(cfg.comp_cfg or {})
    ccfg.setdefault("embed_std", cfg.embed_std)
    return ccfg


def _layer_init(gen: torch.Generator, cfg: LMConfig) -> dict:
    dt, dev = _dt(cfg), gen.device
    p = {
        "attn": MHA.init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, qk_norm=cfg.qk_norm, dtype=dt),
        "ln_attn": RMSNorm.init(cfg.d_model, dt, dev),
        "ln_ffn": RMSNorm.init(cfg.d_model, dt, dev),
    }
    if cfg.moe is not None:
        p["moe"] = MoE.init(gen, cfg.moe, dtype=dt)
    else:
        p["ffn"] = {
            "w_gate": initializers.he_normal(gen, (cfg.d_model, cfg.d_ff)).to(dt),
            "w_up": initializers.he_normal(gen, (cfg.d_model, cfg.d_ff)).to(dt),
            "w_down": initializers.he_normal(gen, (cfg.d_ff, cfg.d_model)).to(dt),
        }
    return p


def _layer(layers: dict, i: int) -> dict:
    """Layer ``i`` of the stacked layer tree: views, no copies."""
    return tree_map(lambda x: x[i], layers)


def causal_attention(q, k, v, n_kv_heads: int) -> torch.Tensor:
    """Causal attention of q (B, S, Hq, hd) over k, v (B, S, Hkv, hd) on the
    flash kernel, in float32; S is right-padded to the kernel's blocks of
    128 (a padded key lies after every real row, so the causal mask keeps
    it out) and the output cast back to q's dtype."""
    s = q.shape[1]
    pad = (-s) % BLOCK if s > BLOCK else 0
    q32, k32, v32 = (x.to(torch.float32) for x in (q, k, v))
    if pad:
        q32, k32, v32 = (F.pad(x, (0, 0, 0, 0, 0, pad))
                         for x in (q32, k32, v32))
    out = flash_attention(q32, k32, v32, n_kv_heads=n_kv_heads, causal=True)
    return out[:, :s].to(q.dtype)


class LM:
    @staticmethod
    def init(gen: torch.Generator, cfg: LMConfig, freqs=None):
        """(params, buffers) from ``gen``, on its device: the token table
        of ``cfg.compressor``, the stacked layers, the final norm and the
        LM head, in ``cfg.dtype`` (the table and the router in float32)."""
        comp = get_compressor(cfg.compressor)
        if freqs is None:
            # a uniform prior, float64 as the compressors' priors are
            freqs = torch.ones((cfg.vocab,), dtype=torch.float64)  # staticcheck: ignore[RL404]
        emb_params, emb_buffers = comp.init(gen, cfg.vocab, cfg.d_model,
                                            freqs, _comp_cfg(cfg))
        per_layer = [_layer_init(gen, cfg) for _ in range(cfg.n_layers)]
        layers = tree_map(lambda *xs: torch.stack(xs), *per_layer)
        del per_layer
        dt = _dt(cfg)
        params = {
            "embedding": emb_params,
            "layers": layers,
            "ln_f": RMSNorm.init(cfg.d_model, dt, gen.device),
            "lm_head": initializers.normal(gen, (cfg.d_model, cfg.vocab),
                                           std=0.02).to(dt),
        }
        return params, {"embedding": emb_buffers}

    @staticmethod
    def _layer_apply(cfg: LMConfig, x, layer_params, *, positions,
                     cache_k=None, cache_v=None, cache_len=None,
                     cache_k_scale=None, cache_v_scale=None,
                     empty_cache: bool = False):
        """x: (B,S,d). Returns (x_out, aux_loss, cache_k, cache_v, k_scale,
        v_scale) — the caches written in place; the scales are None unless
        the caches are int8. ``empty_cache``: the caches hold nothing yet
        (one shared length 0), so a prompt attends on the flash kernel."""
        p = layer_params
        h = RMSNorm.apply(p["ln_attn"], x)
        b, s, _ = h.shape
        nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = Dense.apply(p["attn"]["wq"], h).reshape(b, s, nh, hd)
        k = Dense.apply(p["attn"]["wk"], h).reshape(b, s, nkv, hd)
        v = Dense.apply(p["attn"]["wv"], h).reshape(b, s, nkv, hd)
        if cfg.qk_norm:
            q = RMSNorm.apply(p["attn"]["q_norm"], q)
            k = RMSNorm.apply(p["attn"]["k_norm"], k)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

        if cache_k is not None:
            kv_cache_write_kv(cache_k, cache_k_scale, k, cache_v,
                              cache_v_scale, v, cache_len)
            if empty_cache and s > 1:
                k_att, v_att = cache_k[:, :s], cache_v[:, :s]
                if cache_k.dtype == torch.int8:
                    k_att = dequantize_symmetric(k_att, cache_k_scale, q.dtype)
                    v_att = dequantize_symmetric(v_att, cache_v_scale, q.dtype)
                attn = causal_attention(q, k_att, v_att, nkv)
            else:
                attn = decode_attention(q, cache_k, cache_v, cache_k_scale,
                                        cache_v_scale, q_offset=cache_len,
                                        kv_valid_len=cache_len + s)
        else:
            attn = causal_attention(q, k, v, nkv)
        x = x + Dense.apply(p["attn"]["wo"], attn.reshape(b, s, nh * hd))

        h = RMSNorm.apply(p["ln_ffn"], x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.moe is not None:
            ff, aux = MoE.apply(p["moe"], h, cfg.moe)
        else:
            w = p["ffn"]
            ff = (F.silu(h @ w["w_gate"]) * (h @ w["w_up"])) @ w["w_down"]
        return (x + ff, aux, cache_k, cache_v, cache_k_scale, cache_v_scale)

    @staticmethod
    def _cache_write(cache, update, start):
        """Write ``update`` (B, s, H, hd) into ``cache`` (B, T, H, hd) at
        sequence offset ``start`` (one shared length or one a row (B,)),
        in place; the start is clamped to [0, T - s]. Returns ``cache``."""
        return kv_cache_write(cache, None, update, start)

    @staticmethod
    def _requant_cache(cache, scale, new_vals, cache_len):
        """Write ``new_vals`` into an int8 cache with running-absmax scales,
        both in place (``kernels/kv_cache_write``): the scale is set
        outright at length 0 and only grows otherwise, the stored codes of
        a row whose scale grew re-projected onto its coarser grid. Returns
        (cache, scale)."""
        kv_cache_write(cache, scale, new_vals, cache_len)
        return cache, scale

    @staticmethod
    def _trunk(params, buffers, tokens, cfg: LMConfig, *, positions=None,
               kv_caches=None, train: bool = False, step=None,
               empty: bool | None = None):
        """The token lookup and the layers: (x (B, S, d) before the final
        norm, the summed aux loss, the caches or None). ``empty``: whether
        a prompt of S > 1 goes into caches that hold nothing yet (None:
        read their length on the host)."""
        comp = get_compressor(cfg.compressor)
        x = comp.lookup(params["embedding"], buffers["embedding"], tokens,
                        _comp_cfg(cfg), train=train, step=step).to(_dt(cfg))
        s = tokens.shape[1]
        dev = x.device
        cache_len = kv_caches["len"] if kv_caches is not None else None
        if positions is None:
            offset = (torch.as_tensor(cache_len, device=dev)
                      if kv_caches is not None else torch.zeros((), device=dev,
                                                                dtype=torch.int32))
            # scalar offset -> (1, S); per-slot (B,) -> (B, S)
            positions = offset.reshape(-1, 1) + torch.arange(s, device=dev)[None, :]
        # a prompt into caches that hold nothing yet: read on the host, so
        # only where S > 1 (a decode step never waits on the host)
        if empty is None:
            empty = (kv_caches is not None and s > 1
                     and torch.as_tensor(cache_len).ndim == 0
                     and int(cache_len) == 0)
        quant = kv_caches is not None and "k_scale" in kv_caches
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        remat = cfg.remat and kv_caches is None and torch.is_grad_enabled()

        def layer(h, lp):
            return LM._layer_apply(cfg, h, lp, positions=positions)[:2]

        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            if remat:
                x, a = checkpoint(layer, x, lp, use_reentrant=False)
            elif kv_caches is None:
                x, a = layer(x, lp)
            else:
                x, a, *_ = LM._layer_apply(
                    cfg, x, lp, positions=positions,
                    cache_k=kv_caches["k"][i], cache_v=kv_caches["v"][i],
                    cache_len=cache_len,
                    cache_k_scale=kv_caches["k_scale"][i] if quant else None,
                    cache_v_scale=kv_caches["v_scale"][i] if quant else None,
                    empty_cache=empty)
            aux = aux + a
        new_caches = None
        if kv_caches is not None:
            new_caches = dict(kv_caches, len=cache_len + s)
        return x, aux, new_caches

    @staticmethod
    def _forward(params, buffers, tokens, cfg: LMConfig, *, positions=None,
                 kv_caches=None, train: bool = False, step=None,
                 last_only: bool = False, empty: bool | None = None):
        x, aux, new_caches = LM._trunk(params, buffers, tokens, cfg,
                                       positions=positions,
                                       kv_caches=kv_caches, train=train,
                                       step=step, empty=empty)
        if last_only:
            x = x[:, -1:]
        logits = RMSNorm.apply(params["ln_f"], x) @ params["lm_head"]
        return logits, aux, new_caches

    @staticmethod
    def apply(params, buffers, tokens, cfg: LMConfig, *, positions=None,
              kv_caches=None, train: bool = False, step=None):
        """tokens: (B, S) -> (logits (B,S,V), aux_loss, new_kv_caches)."""
        return LM._forward(params, buffers, tokens, cfg, positions=positions,
                           kv_caches=kv_caches, train=train, step=step)

    @staticmethod
    def hidden_states(params, buffers, tokens, cfg: LMConfig, *,
                      train: bool = False, step=None):
        """Final-layer hidden states after the final norm, (B, S, d), and
        the aux loss: the big-vocabulary cross-entropy's input."""
        x, aux, _ = LM._trunk(params, buffers, tokens, cfg, train=train,
                              step=step)
        return RMSNorm.apply(params["ln_f"], x), aux

    @staticmethod
    def loss_fn(params, buffers, batch, cfg: LMConfig, *,
                aux_weight: float = 0.01, train: bool = True, step=None):
        """batch: {"tokens": (B, S), "labels": (B, S)} -> (loss, ce): the
        mean next-token cross-entropy plus ``aux_weight`` times the aux
        loss. As the reference returns it, ``ce`` is the mean (a 0-d
        tensor) with ``cfg.ce_chunk`` set, else each token's (B, S, 1)."""
        labels = batch["labels"]
        if cfg.ce_chunk:
            x, aux = LM.hidden_states(params, buffers, batch["tokens"], cfg,
                                      train=train, step=step)
            ce = chunked_softmax_xent(x, params["lm_head"], labels,
                                      chunk=cfg.ce_chunk)
            return ce + aux_weight * aux, ce
        logits, aux, _ = LM.apply(params, buffers, batch["tokens"], cfg,
                                  train=train, step=step)
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        ce = -torch.gather(logp, -1, labels[..., None].long())
        return torch.mean(ce) + aux_weight * aux, ce

    @staticmethod
    def make_kv_caches(cfg: LMConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, prefill_len: int = 0,
                       kv_scale_init: float = 0.05, device=None):
        """Zeroed caches on ``device`` (the CPU unless named); an int8
        cache with per-(layer, row, head) scales seeded at
        ``kv_scale_init`` (the first write into an empty cache calibrates
        its own)."""
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        caches = {"k": torch.zeros(shape, dtype=dtype, device=device),
                  "v": torch.zeros(shape, dtype=dtype, device=device),
                  "len": torch.tensor(prefill_len, dtype=torch.int32,
                                      device=device)}
        if dtype == torch.int8:
            sshape = (cfg.n_layers, batch, 1, cfg.n_kv_heads, 1)
            caches["k_scale"] = torch.full(sshape, kv_scale_init,
                                           dtype=torch.float32, device=device)
            caches["v_scale"] = torch.full(sshape, kv_scale_init,
                                           dtype=torch.float32, device=device)
        return caches

    @staticmethod
    def decode_step(params, buffers, tokens, kv_caches, cfg: LMConfig):
        """One-token serving step. tokens: (B, 1)."""
        logits, _, new_caches = LM.apply(params, buffers, tokens, cfg,
                                         kv_caches=kv_caches)
        return logits[:, -1], new_caches

    @staticmethod
    def decode_step_slotted(params, buffers, tokens, lens, kv_caches,
                            cfg: LMConfig):
        """One continuous-batching decode step: per-slot cache lengths.

        ``tokens``: (B, 1); ``lens``: (B,) int32 — each slot's valid length,
        owned by the scheduler (a freed slot rejoins at 0, which re-seeds
        its int8 scale on the first write); ``kv_caches``:
        {"k","v"[,"k_scale","v_scale"]} without "len". Returns (logits
        (B, V), the caches, written in place)."""
        caches = dict(kv_caches, len=lens)
        logits, _, new_caches = LM.apply(params, buffers, tokens, cfg,
                                         kv_caches=caches)
        new_caches.pop("len")
        return logits[:, -1], new_caches

    @staticmethod
    def prefill(params, buffers, tokens, cfg: LMConfig, max_len: int,
                cache_dtype=torch.bfloat16):
        """Prompt pass that fills fresh caches on ``tokens``' device.
        tokens: (B, S) -> (logits (B, V) at the last position, caches). The
        LM head runs at that position only: the one row returned."""
        caches = LM.make_kv_caches(cfg, tokens.shape[0], max_len, cache_dtype,
                                   device=tokens.device)
        # the caches are this call's own, fresh: no host read of their length
        logits, _, caches = LM._forward(params, buffers, tokens, cfg,
                                        kv_caches=caches, last_only=True,
                                        empty=tokens.shape[1] > 1)
        return logits[:, -1], caches
