"""two-tower-retrieval [RecSys'19 (YouTube); unverified]: dot-product
retrieval, tower MLP 1024-512-256 (output = the 256-d dot space).

Tables: 4 user fields × 8,388,608 + 4 item fields × 2,097,152 = 41.9 M rows,
id-embedding d = 64, in one table; in-batch sampled softmax with logQ
correction. The numbers are the reference's
``configs/two_tower_retrieval.py``."""
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, register_arch
from repro_torch.embeddings.table import FieldSpec
from repro_torch.models.two_tower import TwoTowerConfig

USER_VOCAB = 8_388_608
ITEM_VOCAB = 2_097_152


def make_config(reduced: bool = False) -> TwoTowerConfig:
    if reduced:
        uf = tuple(FieldSpec(f"u{i}", 1_000) for i in range(2))
        itf = tuple(FieldSpec(f"i{i}", 500) for i in range(2))
        return TwoTowerConfig(user_fields=uf, item_fields=itf, d_embed=16,
                              tower_hidden=(32, 16), compressor="mpe_search")
    uf = tuple(FieldSpec(f"u{i}", USER_VOCAB) for i in range(4))
    itf = tuple(FieldSpec(f"i{i}", ITEM_VOCAB) for i in range(4))
    return TwoTowerConfig(user_fields=uf, item_fields=itf, d_embed=64,
                          tower_hidden=(1024, 512, 256),
                          compressor="mpe_search")


ARCH = register_arch(ArchSpec(
    arch_id="two-tower-retrieval", family="recsys", make_config=make_config,
    shapes=RECSYS_SHAPES, citation="RecSys'19 (YouTube); unverified",
))
