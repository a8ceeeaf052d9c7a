"""The global-norm clip's norm and scale over a tree of gradient leaves, in
one read of the leaves: ``gnorm = sqrt(Σ g²)`` and ``scale = min(1,
max_norm / (gnorm + 1e-12))``."""
