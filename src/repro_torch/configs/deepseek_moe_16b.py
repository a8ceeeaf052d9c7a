"""deepseek-moe-16b [arXiv:2401.06066; hf] — fine-grained MoE.

28L d_model=2048 16H (kv=16) per-expert d_ff=1408 vocab=102400,
2 shared + 64 routed experts, top-6. The numbers are the reference's
``configs/deepseek_moe_16b.py``.
"""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, register_arch
from repro_torch.models.lm import LMConfig
from repro_torch.nn.moe import MoEConfig


def make_config(reduced: bool = False) -> LMConfig:
    if reduced:
        return LMConfig(name="deepseek-moe-16b-smoke", n_layers=2, d_model=64,
                        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=512,
                        moe=MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=32,
                                      n_shared=2))
    return LMConfig(
        name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16,
        n_kv_heads=16, head_dim=128, d_ff=1408, vocab=102400,
        moe=MoEConfig(n_experts=64, top_k=6, d_model=2048, d_ff=1408,
                      n_shared=2, capacity_factor=1.25),
        dtype="bfloat16", attn_chunk_q=512, attn_chunk_kv=1024, ce_chunk=512,
    )


ARCH = register_arch(ArchSpec(
    arch_id="deepseek-moe-16b", family="lm", make_config=make_config,
    shapes=LM_SHAPES, citation="arXiv:2401.06066; hf",
    notes="2 shared + 64 routed top-6 fine-grained; EP over model axis",
))
