"""The embedding bag: the masked sum of the gathered rows of every bag, with
its dense table gradient."""
from repro_torch.kernels.embedding_bag.ops import embedding_bag_kernel
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

__all__ = ["embedding_bag_kernel", "embedding_bag_ref"]
