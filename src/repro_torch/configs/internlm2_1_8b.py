"""internlm2-1.8b [arXiv:2403.17297; hf] — dense, GQA kv=8.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544. The numbers are the
reference's ``configs/internlm2_1_8b.py``.
"""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, register_arch
from repro_torch.models.lm import LMConfig


def make_config(reduced: bool = False) -> LMConfig:
    if reduced:
        return LMConfig(name="internlm2-1.8b-smoke", n_layers=2, d_model=64,
                        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                        vocab=512)
    return LMConfig(
        name="internlm2-1.8b", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=8, head_dim=128, d_ff=8192, vocab=92544,
        dtype="bfloat16", attn_chunk_q=512, attn_chunk_kv=1024, ce_chunk=512,
    )


ARCH = register_arch(ArchSpec(
    arch_id="internlm2-1.8b", family="lm", make_config=make_config,
    shapes=LM_SHAPES, citation="arXiv:2403.17297; hf",
))
