"""The DLRM backbones with their interaction operators, and SASRec."""
from repro_torch.models.dlrm import DLRM, DLRMConfig

__all__ = ["DLRM", "DLRMConfig"]
