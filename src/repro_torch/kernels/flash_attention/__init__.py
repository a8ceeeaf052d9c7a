"""Flash attention over (B·H, S, hd): the online-softmax forward, the
forward with its logsumexp rows, and the backward from them."""
