"""The gathers' backward summing only the first half of its rows: the
table's and the width probabilities' gradients come out wrong while the
dense leaves' stay right."""
import importlib


def plant(mp):
    # by its path: the package ``repro_torch.kernels`` exports a function
    # of the same name as the module
    ops = importlib.import_module("repro_torch.kernels.segment_sum.ops")
    whole = ops.segment_sum

    def segment_sum(grad, ids, n, **kw):
        grad = grad.clone()
        grad[grad.shape[0] // 2:] = 0
        return whole(grad, ids, n, **kw)
    segment_sum.launches = 0
    mp.setattr(ops, "segment_sum", segment_sum)
