"""gin-tu [arXiv:1810.00826; paper]: GIN, 5 layers, d = 64, sum
aggregation, learnable ε.

Shape cells carry their own graph geometry (``base.GNN_SHAPES``):
  full_graph_sm: cora   (2,708 / 10,556, d_feat 1,433, 7 classes)
  minibatch_lg:  reddit (232,965 / 114,615,892, d_feat 602, 41 classes,
                 fanout 15-10)
  ogb_products:         (2,449,029 / 61,859,140, d_feat 100, 47 classes)
  molecule:      128 graphs × (30 / 64), atom vocab 119, graph-level binary

MPE applies only to the molecule cell's categorical atom embedding; the
dense-feature cells run without the technique. The numbers are the
reference's ``configs/gin_tu.py``."""
from typing import NamedTuple

from repro_torch.configs.base import GNN_SHAPES, ArchSpec, register_arch
from repro_torch.models.gnn import GINConfig


class GraphCell(NamedTuple):
    n_nodes: int
    n_edges: int
    d_feat: int
    n_classes: int
    input_mode: str = "dense"
    readout: str = "node"
    batch_nodes: int = 0           # minibatch cells
    fanout: tuple = ()
    n_graphs: int = 0              # molecule cells
    atom_vocab: int = 0


GRAPH_CELLS = {
    "full_graph_sm": GraphCell(2_708, 10_556, 1_433, 7),
    "minibatch_lg": GraphCell(232_965, 114_615_892, 602, 41,
                              batch_nodes=1_024, fanout=(15, 10)),
    "ogb_products": GraphCell(2_449_029, 61_859_140, 100, 47),
    "molecule": GraphCell(30, 64, 0, 2, input_mode="categorical",
                          readout="graph", n_graphs=128, atom_vocab=119),
}


def make_config(reduced: bool = False,
                shape: str = "full_graph_sm") -> GINConfig:
    cell = GRAPH_CELLS[shape]
    if reduced:
        return GINConfig(n_layers=2, d_hidden=16,
                         d_in=min(cell.d_feat, 32) or 16,
                         n_classes=cell.n_classes,
                         input_mode=cell.input_mode, readout=cell.readout,
                         atom_vocab=cell.atom_vocab or 119)
    return GINConfig(n_layers=5, d_hidden=64, d_in=cell.d_feat or 64,
                     n_classes=cell.n_classes, input_mode=cell.input_mode,
                     readout=cell.readout, atom_vocab=cell.atom_vocab or 119,
                     compressor=("mpe_search"
                                 if cell.input_mode == "categorical"
                                 else "plain"))


ARCH = register_arch(ArchSpec(
    arch_id="gin-tu", family="gnn", make_config=make_config,
    shapes=GNN_SHAPES, citation="arXiv:1810.00826; paper",
    notes="MPE applies to the molecule cell's atom-type table only",
))
