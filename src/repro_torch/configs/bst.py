"""bst [arXiv:1905.06874; paper]: embed_dim=32, seq_len=20, 1 transformer
block, 8 heads, MLP 1024-512-256; an item vocabulary of 16,777,216 and 4
context fields of 65,536, in one table, trained with the MPE search. The
numbers are the reference's ``configs/bst.py``."""
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, register_arch
from repro_torch.embeddings.table import FieldSpec
from repro_torch.models.bst import BSTConfig

ITEM_VOCAB = 16_777_216
CTX_VOCAB = 65_536


def make_config(reduced: bool = False) -> BSTConfig:
    if reduced:
        return BSTConfig(item_vocab=2_000,
                         ctx_fields=(FieldSpec("c0", 100),),
                         d_embed=16, seq_len=8, mlp_hidden=(32, 16),
                         compressor="mpe_search")
    return BSTConfig(
        item_vocab=ITEM_VOCAB,
        ctx_fields=tuple(FieldSpec(f"c{i}", CTX_VOCAB) for i in range(4)),
        d_embed=32, seq_len=20, n_blocks=1, n_heads=8,
        mlp_hidden=(1024, 512, 256), compressor="mpe_search",
    )


ARCH = register_arch(ArchSpec(
    arch_id="bst", family="recsys", make_config=make_config,
    shapes=RECSYS_SHAPES, citation="arXiv:1905.06874; paper",
))
