"""Graph networks: GIN."""
from repro_torch.models.gnn.gin import GIN, GINConfig

__all__ = ["GIN", "GINConfig"]
