"""wide-deep [arXiv:1606.07792; paper] — 40 sparse fields, d=32, MLP
1024-512-256: the reference's ``configs/wide_deep.py``.

Tables: 40 fields × 1,048,576 rows = 41,943,040 rows (Zipf-popular).
Training runs the MPE search phase (the paper's system); serving uses the
bit-packed mixed-precision table (§4). Reduced: 6 fields × 1,000 rows and
a (64, 32) MLP.
"""
from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, register_arch
from repro_torch.embeddings.table import FieldSpec
from repro_torch.models.wide_deep import WideDeepConfig

N_FIELDS = 40
FIELD_VOCAB = 1_048_576


def fields(reduced: bool = False):
    v = 1_000 if reduced else FIELD_VOCAB
    n = 6 if reduced else N_FIELDS
    return tuple(FieldSpec(f"f{i}", v) for i in range(n))


def make_config(reduced: bool = False) -> WideDeepConfig:
    return WideDeepConfig(
        fields=fields(reduced),
        d_embed=32,
        mlp_hidden=(64, 32) if reduced else (1024, 512, 256),
        compressor="mpe_search",
    )


ARCH = register_arch(ArchSpec(
    arch_id="wide-deep", family="recsys", make_config=make_config,
    shapes=RECSYS_SHAPES, citation="arXiv:1606.07792; paper",
))
