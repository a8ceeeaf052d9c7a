"""Baseline compressors of paper Table 3."""
from repro_torch.core.baselines.plain import PlainEmbedding
from repro_torch.core.baselines.lsq_uniform import LSQUniform
from repro_torch.core.baselines.alpt import ALPT
from repro_torch.core.baselines.qr_trick import QRTrick
from repro_torch.core.baselines.pep import PEP
from repro_torch.core.baselines.optfs import OptFS

__all__ = ["PlainEmbedding", "LSQUniform", "ALPT", "QRTrick", "PEP", "OptFS"]
