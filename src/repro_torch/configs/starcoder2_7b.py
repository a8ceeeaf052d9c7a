"""starcoder2-7b [arXiv:2402.19173; hf] — dense, GQA kv=4, RoPE.

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152. The numbers are the
reference's ``configs/starcoder2_7b.py``; its ``seq_shard_attn`` places
attention on a mesh and changes nothing on one device.
"""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, register_arch
from repro_torch.models.lm import LMConfig


def make_config(reduced: bool = False) -> LMConfig:
    if reduced:
        return LMConfig(name="starcoder2-7b-smoke", n_layers=2, d_model=96,
                        n_heads=6, n_kv_heads=2, head_dim=16, d_ff=192,
                        vocab=512, seq_shard_attn=False)
    return LMConfig(
        name="starcoder2-7b", n_layers=32, d_model=4608, n_heads=36,
        n_kv_heads=4, head_dim=128, d_ff=18432, vocab=49152,
        dtype="bfloat16", attn_chunk_q=512, attn_chunk_kv=1024,
        ce_chunk=512, seq_shard_attn=True,
    )


ARCH = register_arch(ArchSpec(
    arch_id="starcoder2-7b", family="lm", make_config=make_config,
    shapes=LM_SHAPES, citation="arXiv:2402.19173; hf",
    notes="36 q-heads % 16 != 0 -> sequence-sharded attention",
))
