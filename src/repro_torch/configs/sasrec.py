"""sasrec [arXiv:1808.09781; paper]: d=50, 2 blocks, 1 head, sequences of
50, an item vocabulary of 8,388,608 (one table for input and output),
trained with the MPE search. The numbers are the reference's
``configs/sasrec.py``."""
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, register_arch
from repro_torch.models.sasrec import SASRecConfig

ITEM_VOCAB = 8_388_608


def make_config(reduced: bool = False) -> SASRecConfig:
    if reduced:
        return SASRecConfig(item_vocab=2_000, d_embed=16, seq_len=10,
                            compressor="mpe_search")
    return SASRecConfig(item_vocab=ITEM_VOCAB, d_embed=50, seq_len=50,
                        n_blocks=2, n_heads=1, compressor="mpe_search")


ARCH = register_arch(ArchSpec(
    arch_id="sasrec", family="recsys", make_config=make_config,
    shapes=RECSYS_SHAPES, citation="arXiv:1808.09781; paper",
))
