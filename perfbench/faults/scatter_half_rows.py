"""Half of each dispatch's answers lost (zeroed) where the engine scatters
them."""
import numpy as np


def plant(mp):
    from repro_torch.serve.batcher import RequestBatcher
    scatter = RequestBatcher.scatter

    def broken(y, chunk, outs):
        y = np.array(y)
        y[y.shape[0] // 2:] = 0.0
        return scatter(y, chunk, outs)
    mp.setattr(RequestBatcher, "scatter", staticmethod(broken))
