"""ArchSpec: the contract between configs/, the launchers and the tests.

  make_config(reduced[, backbone | shape]) -> model config NamedTuple
  shapes                         -> tuple of shape-cell names
"""
from __future__ import annotations

from typing import Callable, NamedTuple


class ArchSpec(NamedTuple):
    arch_id: str
    family: str                    # lm | gnn | recsys
    make_config: Callable          # (reduced: bool[, backbone | shape]) -> config
    shapes: tuple
    citation: str = ""
    notes: str = ""


_REGISTRY: dict[str, ArchSpec] = {}


def register_arch(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def _register_all():
    import repro_torch.configs.bst  # noqa: F401  (registers)
    import repro_torch.configs.deepseek_moe_16b  # noqa: F401
    import repro_torch.configs.dlrm_criteo  # noqa: F401
    import repro_torch.configs.gin_tu  # noqa: F401
    import repro_torch.configs.grok_1_314b  # noqa: F401
    import repro_torch.configs.internlm2_1_8b  # noqa: F401
    import repro_torch.configs.qwen3_32b  # noqa: F401
    import repro_torch.configs.sasrec  # noqa: F401
    import repro_torch.configs.starcoder2_7b  # noqa: F401
    import repro_torch.configs.two_tower_retrieval  # noqa: F401
    import repro_torch.configs.wide_deep  # noqa: F401


def get_arch(arch_id: str) -> ArchSpec:
    _register_all()
    return _REGISTRY[arch_id]


def ALL_ARCHS():
    _register_all()
    return sorted(_REGISTRY)


# the LM cells of the reference's configs/base.py
LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


# the graph cells of the reference's configs/base.py, each with its own
# geometry (configs/gin_tu.py)
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
# the recsys cells of the reference's launch/cells.py, and the rows of its
# serving cells
RECSYS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
SERVE_ROWS = {"serve_p99": 512, "serve_bulk": 262144}
