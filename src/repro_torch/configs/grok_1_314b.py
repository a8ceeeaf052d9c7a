"""grok-1-314b [hf:xai-org/grok-1; unverified] — 8-expert MoE, top-2.

64L d_model=6144 48H (GQA kv=8) per-expert d_ff=32768 vocab=131072. The
numbers are the reference's ``configs/grok_1_314b.py``.
"""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, register_arch
from repro_torch.models.lm import LMConfig
from repro_torch.nn.moe import MoEConfig


def make_config(reduced: bool = False) -> LMConfig:
    if reduced:
        return LMConfig(name="grok-1-smoke", n_layers=2, d_model=64,
                        n_heads=6, n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
                        moe=MoEConfig(n_experts=4, top_k=2, d_model=64, d_ff=64))
    return LMConfig(
        name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48,
        n_kv_heads=8, head_dim=128, d_ff=32768, vocab=131072,
        moe=MoEConfig(n_experts=8, top_k=2, d_model=6144, d_ff=32768,
                      capacity_factor=1.25),
        dtype="bfloat16", attn_chunk_q=256, attn_chunk_kv=1024, ce_chunk=256,
    )


ARCH = register_arch(ArchSpec(
    arch_id="grok-1-314b", family="lm", make_config=make_config,
    shapes=LM_SHAPES, citation="hf:xai-org/grok-1; unverified",
    notes="8 experts % 16 != 0 -> TP within experts over d_ff",
))
