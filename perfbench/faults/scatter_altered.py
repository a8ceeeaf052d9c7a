"""One answer of each dispatch altered where the engine scatters it."""
import numpy as np


def plant(mp):
    from repro_torch.serve.batcher import RequestBatcher
    scatter = RequestBatcher.scatter

    def broken(y, chunk, outs):
        y = np.array(y)
        y[0] += 1.0
        return scatter(y, chunk, outs)
    mp.setattr(RequestBatcher, "scatter", staticmethod(broken))
