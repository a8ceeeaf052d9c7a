"""Flash attention over (B·H, S, hd): the online-softmax forward, the
forward with its logsumexp rows, and the backward from them."""
from repro_torch.kernels.flash_attention.ops import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["flash_attention_kernel", "flash_attention_ref"]
