"""Mixture-of-Experts FFN with token-choice top-k routing, as the
reference's ``repro/nn/moe.py`` routes it.

Gather-based capacity dispatch (no (T, E, C) one-hot tensor): tokens pick
their top-k experts; a (T·k, E) cumulative sum gives each (token, choice)
its slot in its expert's capacity buffer; dispatch is a gather, and the
combine — the reference's ``jax.ops.segment_sum`` of the gate-weighted
expert outputs back to their tokens — is ``kernels/segment_sum``'s
``scatter_sum`` (the CUDA kernel on the card). Both gathers, the dispatch
``xt[dispatch]`` and the combine's ``ye[slot]``, are
``kernels/segment_sum``'s ``gather`` on the rows as they are, so their
backward is the segment-sum kernel too (in float32, rounded once to the
rows' type): no library scatter-add runs in a training step. The
capacity, the top-k choices, ``pos_in_expert``, ``keep`` and ``slot`` are
the reference's integers exactly; choices past an expert's capacity are
dropped. Supports
DeepSeekMoE's always-on shared experts and int8 expert weights
({"q", "scale"}, per-expert scales, dequantized on use).

The reference's ``shard_dispatch`` pins the dispatch buffers to a mesh; on
one device it changes nothing, and the port reads it and leaves it so.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.quantizer import dequantize_symmetric
from repro_torch.kernels.segment_sum.ops import gather, scatter_sum
from repro_torch.nn import init as initializers


class MoEConfig(NamedTuple):
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int              # per-expert hidden
    n_shared: int = 0      # always-on shared experts
    capacity_factor: float = 1.25
    shard_dispatch: bool = False       # mesh-only: no effect on one device
    expert_weight_int8: bool = False


def _he_normal(gen, shape):
    """N(0, 2 / fan_in) with fan_in the second-to-last dim (the reference's
    initializer on a stacked (E, d_in, d_out) tensor)."""
    return torch.randn(shape, generator=gen, device=gen.device) * (
        2.0 / shape[-2]) ** 0.5


def _ffn_init(gen, d_model, d_ff, dtype):
    return {  # SwiGLU (LLaMA/grok/deepseek convention)
        "w_gate": initializers.he_normal(gen, (d_model, d_ff)).to(dtype),
        "w_up": initializers.he_normal(gen, (d_model, d_ff)).to(dtype),
        "w_down": initializers.he_normal(gen, (d_ff, d_model)).to(dtype),
    }


def ffn_apply(p, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def routing(xt: torch.Tensor, router: torch.Tensor, cfg: MoEConfig) -> dict:
    """The reference's routing of T tokens (T, d): float32 router logits,
    softmax gates, the top-k choices and their renormalized weights, each
    choice's position in its expert, whether it fits the capacity, and its
    slot in the (E·C) dispatch buffer."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = max(1, int(cfg.capacity_factor * k * t / e))
    logits = xt.to(torch.float32) @ router                         # (T, E)
    gates = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(gates, k, dim=-1)                      # (T, k)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    experts = torch.arange(e, device=xt.device)
    flat_oh = (topi.reshape(t * k, 1) == experts).to(torch.int32)  # (T·k, E)
    pos = torch.cumsum(flat_oh, dim=0, dtype=torch.int32) * flat_oh  # 1-based
    pos_in_expert = pos.amax(dim=-1) - 1                           # (T·k,)
    expert_id = topi.reshape(t * k).to(torch.int32)
    keep = pos_in_expert < cap
    slot = expert_id * cap + torch.clamp(pos_in_expert, 0, cap - 1)
    return {"cap": cap, "gates": gates, "topw": topw, "topi": topi,
            "pos_in_expert": pos_in_expert, "keep": keep, "slot": slot}


class MoE:
    @staticmethod
    def init(gen: torch.Generator, cfg: MoEConfig, dtype=torch.float32):
        e = cfg.n_experts

        def _expert_mat(shape):
            w = _he_normal(gen, shape)
            if cfg.expert_weight_int8:
                scale = w.abs().amax(dim=(1, 2), keepdim=True) / 127.0
                return {"q": torch.round(w / scale).to(torch.int8),
                        "scale": scale}
            return w.to(dtype)

        params = {
            "router": initializers.normal(gen, (cfg.d_model, e), std=0.02),
            "experts": {
                "w_gate": _expert_mat((e, cfg.d_model, cfg.d_ff)),
                "w_up": _expert_mat((e, cfg.d_model, cfg.d_ff)),
                "w_down": _expert_mat((e, cfg.d_ff, cfg.d_model)),
            },
        }
        if cfg.n_shared:
            params["shared"] = _ffn_init(gen, cfg.d_model,
                                         cfg.d_ff * cfg.n_shared, dtype)
        return params

    @staticmethod
    def apply(params, x, cfg: MoEConfig):
        """x: (B, S, d) -> (B, S, d), aux_loss (load-balance)."""
        b, s, d = x.shape
        t = b * s
        xt = x.reshape(t, d)
        e, k = cfg.n_experts, cfg.top_k
        r = routing(xt, params["router"], cfg)
        cap, keep, slot = r["cap"], r["keep"], r["slot"]

        token_of_choice = torch.arange(t, device=x.device).repeat_interleave(k)
        # dispatch: slot -> token index; dropped choices write the spare
        # entry past the end, which is cut off (the reference's mode="drop")
        spare = torch.full_like(slot, e * cap)
        target = torch.where(keep, slot, spare).long()
        dispatch = torch.zeros((e * cap + 1,), dtype=torch.int64,
                               device=x.device)
        dispatch[target] = token_of_choice
        slot_used = torch.zeros((e * cap + 1,), dtype=torch.bool,
                                device=x.device)
        slot_used.index_fill_(0, target, True)
        dispatch, slot_used = dispatch[:e * cap], slot_used[:e * cap]

        xe = gather(xt, dispatch).reshape(e, cap, d)                 # (E, C, d)
        xe = xe * slot_used.reshape(e, cap, 1).to(xe.dtype)
        w = params["experts"]

        def _mat(m):  # dequantize int8 expert weights on use
            if isinstance(m, dict):
                return dequantize_symmetric(m["q"], m["scale"], xe.dtype)
            return m

        h = F.silu(torch.bmm(xe, _mat(w["w_gate"])))
        h = h * torch.bmm(xe, _mat(w["w_up"]))
        ye = torch.bmm(h, _mat(w["w_down"])).reshape(e * cap, d)

        # combine: each kept choice back to its token, gate-weighted
        gathered = gather(ye, slot.clamp(0, e * cap - 1).long())    # (T·k, d)
        wts = (r["topw"].reshape(t * k) * keep.to(torch.float32))[:, None]
        out = scatter_sum((gathered * wts).to(torch.float32),
                          token_of_choice, t)

        if "shared" in params:
            out = out + ffn_apply(params["shared"], xt)

        # Switch-style load-balance auxiliary loss
        first = r["topi"][:, :1] == torch.arange(e, device=x.device)
        density = first.to(torch.float32).mean(dim=0)
        router_prob = r["gates"].mean(dim=0)
        aux = e * torch.sum(density * router_prob)
        return out.reshape(b, s, d).to(x.dtype), aux
