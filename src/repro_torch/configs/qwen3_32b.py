"""qwen3-32b [hf:Qwen/Qwen3-8B family config; hf] — dense, GQA kv=8, qk_norm.

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936. The numbers are
the reference's ``configs/qwen3_32b.py``.
"""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, register_arch
from repro_torch.models.lm import LMConfig


def make_config(reduced: bool = False) -> LMConfig:
    if reduced:
        return LMConfig(name="qwen3-32b-smoke", n_layers=2, d_model=64,
                        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                        vocab=512, qk_norm=True)
    return LMConfig(
        name="qwen3-32b", n_layers=64, d_model=5120, n_heads=64,
        n_kv_heads=8, head_dim=128, d_ff=25600, vocab=151936, qk_norm=True,
        dtype="bfloat16", attn_chunk_q=512, attn_chunk_kv=1024, ce_chunk=256,
    )


ARCH = register_arch(ArchSpec(
    arch_id="qwen3-32b", family="lm", make_config=make_config,
    shapes=LM_SHAPES, citation="hf:Qwen/Qwen3-8B; hf",
    notes="qk_norm per-head RMSNorm",
))
