"""The paper's own benchmark configuration: DLRM backbones at Criteo scale.

39 fields / 34,223,104 features (within 5% of the 33,762,577 of paper
Table 2), d=16, MLP 1024-512-256, candidate widths {0..6}, group size 128 —
§5.1.5 exactly. The backbone is selectable (dnn | dcn | deepfm | ipnn). The
config serves from the packed table: ``comp_cfg`` carries its static meta.
"""
from repro_torch.configs.base import ArchSpec, register_arch
from repro_torch.core.mpe import MPEConfig
from repro_torch.embeddings.table import FieldSpec, total_vocab
from repro_torch.models.dlrm import DLRMConfig

# Criteo has 26 categorical + 13 discretized-numeric fields = 39; vocab sizes
# are heavy-tailed — approximated with a few large id fields + many small ones.
_CRITEO_VOCABS = ([8_388_608, 8_388_608, 4_194_304, 4_194_304, 2_097_152,
                   2_097_152, 1_048_576, 1_048_576] + [262_144] * 8 +
                  [65_536] * 10 + [1_024] * 13)
assert len(_CRITEO_VOCABS) == 39
assert abs(sum(_CRITEO_VOCABS) - 33_762_577) / 33_762_577 < 0.05  # ±5% of Table 2


def make_config(reduced: bool = False, backbone: str = "dnn") -> DLRMConfig:
    if reduced:
        fields = tuple(FieldSpec(f"f{i}", 1_000) for i in range(8))
        hidden = (32, 16)
    else:
        fields = tuple(FieldSpec(f"f{i}", v)
                       for i, v in enumerate(_CRITEO_VOCABS))
        hidden = (1024, 512, 256)
    d = 16
    comp_cfg = {"bits": MPEConfig().bits, "d": d, "n": total_vocab(fields)}
    return DLRMConfig(fields=fields, d_embed=d, mlp_hidden=hidden,
                      backbone=backbone, compressor="packed",
                      comp_cfg=comp_cfg)


ARCH = register_arch(ArchSpec(
    arch_id="dlrm-criteo", family="recsys", make_config=make_config,
    shapes=("serve_p99", "serve_bulk"),
    citation="paper §5.1 (Criteo statistics, Table 2)",
    notes="the paper's own evaluation config",
))
