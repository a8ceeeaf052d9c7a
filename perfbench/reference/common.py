"""Plain PyTorch pieces the references share: the Zipf prior, the MPE
grouping, the LSQ+ quantizer with its straight-through gradients, the MLP
with BatchNorm, the loss and Adam. Written from the paper's equations
(arXiv:2409.20305, Eqs. 4-11) and the models' publications, in float32 on
whatever device the tensors are on. Nothing here imports the program.
"""
from __future__ import annotations

import contextlib
import math

import torch

EMBED_STD = 3e-3          # paper 5.1.5: embeddings N(0, 3e-3)
BN_EPS = 1e-5
LN_EPS = 1e-5


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Float32 products in full float32 (``tf32=False``, what the
    configurations state) or in TF32 (the control)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator for one kind of input: the seed and a salt, so that the
    weights, the batches and the requests of one seed are independent
    streams. Any seed up to 2**63 is taken."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + salt * 0xBF58476D1CE4E5B9) \
        % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


# -- the Zipf prior and the MPE grouping --------------------------------------

def zipf_cdfs(vocabs, exponent: float, device) -> torch.Tensor:
    """Every field's Zipf CDF over its popularity ranks, field f's shifted
    up by f, one float64 vector: an id of field f is the searchsorted of
    ``f + u`` for a uniform ``u``, as a global row."""
    parts = []
    for f, v in enumerate(vocabs):
        p = torch.arange(1, v + 1, dtype=torch.float64,
                         device=device) ** (-exponent)
        parts.append(torch.cumsum(p / p.sum(), 0) + f)
    return torch.cat(parts)


def zipf_pdf(cdfs: torch.Tensor, vocabs) -> torch.Tensor:
    """The per-field probabilities of ``zipf_cdfs``: each row's access
    probability within its field."""
    out, lo = [], 0
    for f, v in enumerate(vocabs):
        c = cdfs[lo:lo + v] - f
        out.append(torch.diff(c, prepend=c.new_zeros(1)))
        lo += v
    return torch.cat(out)


def draw_zipf(gen, cdfs, vocabs, rows: int) -> torch.Tensor:
    """(rows, F) global ids, field f's drawn from its Zipf CDF."""
    f = len(vocabs)
    u = torch.rand((rows, f), generator=gen, device=cdfs.device,
                   dtype=torch.float64)
    u = u + torch.arange(f, device=cdfs.device, dtype=torch.float64)
    ids = torch.searchsorted(cdfs, u)
    ends = torch.tensor(list(vocabs), device=cdfs.device).cumsum(0)
    # a CDF's float sum may end a hair off f + 1: keep each id in its field
    return torch.clamp(ids, min=ends - ends.new_tensor(list(vocabs)),
                       max=ends - 1)


def field_offsets(vocabs, device) -> torch.Tensor:
    v = torch.tensor([0, *vocabs[:-1]], dtype=torch.int64, device=device)
    return torch.cumsum(v, 0)


def make_groups(freqs: torch.Tensor, group_size: int):
    """Paper 3.2: features sorted by frequency (descending, ties in id
    order), cut into groups of ``group_size``. Returns (group of each
    feature, int64; each group's frequency sum, at least 1, float32)."""
    n = freqs.shape[0]
    order = torch.sort(-freqs, stable=True).indices
    gof = torch.empty(n, dtype=torch.int64, device=freqs.device)
    gof[order] = torch.arange(n, device=freqs.device) // group_size
    g = -(-n // group_size)
    sums = torch.zeros(g, dtype=torch.float64, device=freqs.device)
    sums.index_add_(0, gof, freqs.to(torch.float64))
    return gof, torch.clamp(sums, min=1.0).to(torch.float32)


def init_alpha(std: float, b: int) -> float:
    """LSQ's step-size start 2·E|theta| / sqrt(P_b) for theta ~ N(0, std)
    (1 for the dropped width)."""
    if b < 1:
        return 1.0
    return 2.0 * std * math.sqrt(2.0 / math.pi) / math.sqrt(2 ** (b - 1) - 1 or 1)


# -- LSQ+ (paper Eqs. 3-6) ----------------------------------------------------

class _LSQ(torch.autograd.Function):
    """LSQ+ fake quantization at ``b`` bits (Eq. 3) with the paper's
    straight-through gradients written out element by element (Eqs. 4-6),
    the step size's and the offset's summed in float64: their terms
    cancel, and a float32 sum of them is off in its leading digits."""

    @staticmethod
    def forward(ctx, theta, alpha, beta, b):
        lo, hi = -(2 ** (b - 1)), 2 ** (b - 1) - 1
        v = (theta - beta) / alpha
        vbar = torch.clamp(torch.round(v), lo, hi)
        ctx.save_for_backward(v, vbar)
        ctx.b, ctx.beta_shape = b, beta.shape
        return alpha * vbar + beta

    @staticmethod
    def backward(ctx, g):
        v, vbar = ctx.saved_tensors
        lo, hi = -(2 ** (ctx.b - 1)), 2 ** (ctx.b - 1) - 1
        inside = (v > lo) & (v < hi)
        d_theta = torch.where(inside, g, 0.0)                          # Eq. 4
        slope = torch.where(v <= lo, float(lo),
                            torch.where(v >= hi, float(hi), vbar - v))
        d_alpha = (g.double() * slope).sum().float()                   # Eq. 5
        d_beta = torch.where(inside, 0.0, g).double().reshape(
            -1, g.shape[-1]).sum(0).float().reshape(ctx.beta_shape)   # Eq. 6
        return d_theta, d_alpha, d_beta, None


def lsq(theta, alpha, beta, b: int):
    """Fake quantization at ``b`` bits: alpha * clamp(round(v)) + beta with
    v = (theta - beta) / alpha, and its straight-through gradients."""
    return _LSQ.apply(theta, alpha, beta, b)


def mixture(rows, probs, alpha, beta, bits):
    """Eq. 9: sum_i p_i Q(e, alpha_i, beta, b_i), width 0 adding nothing."""
    out = torch.zeros_like(rows)
    for i, b in enumerate(bits):
        if b:
            out = out + probs[..., i:i + 1] * lsq(rows, alpha[i], beta, b)
    return out


def dequantize(rows, widx, alpha, beta, bits):
    """A served row at its width: the LSQ+ code dequantized, or 0 where
    the width is 0 (paper 4)."""
    out = torch.zeros_like(rows)
    for i, b in enumerate(bits):
        if b:
            sel = widx == i
            lo, hi = -(2 ** (b - 1)), 2 ** (b - 1) - 1
            code = torch.clamp(torch.round((rows - beta) / alpha[i]), lo, hi)
            out = torch.where(sel[..., None], alpha[i] * code + beta, out)
    return out


def sample_widths(gamma, tau: float, bits):
    """Eq. 11: per group, the highest width whose probability exceeds
    1 / (2m)."""
    p = torch.softmax(gamma / tau, dim=-1)
    m = len(bits)
    idx = torch.arange(m, device=gamma.device)
    return torch.where(p > 1.0 / (2 * m), idx, -1).amax(dim=-1)


# -- dense layers -------------------------------------------------------------

def glorot(gen, d_in: int, d_out: int, device) -> torch.Tensor:
    limit = math.sqrt(6.0 / (d_in + d_out))
    return (torch.rand((d_in, d_out), generator=gen, device=device)
            * (2 * limit) - limit)


def mlp_weights(gen, d_in: int, hidden, device, prefix: str = "mlp") -> dict:
    """A tower of ``hidden`` widths with BatchNorm and a 1-wide head, at
    its start: glorot kernels, zero biases, unit BatchNorm scales."""
    dims = [d_in, *hidden]
    w = {}
    for i in range(len(hidden)):
        w[f"{prefix}.layers.{i}.kernel"] = glorot(gen, dims[i], dims[i + 1],
                                                  device)
        w[f"{prefix}.layers.{i}.bias"] = torch.zeros(dims[i + 1], device=device)
    for i, h in enumerate(hidden):
        w[f"{prefix}.bn.{i}.scale"] = torch.ones(h, device=device)
        w[f"{prefix}.bn.{i}.bias"] = torch.zeros(h, device=device)
    w[f"{prefix}.head.kernel"] = glorot(gen, dims[-1], 1, device)
    w[f"{prefix}.head.bias"] = torch.zeros(1, device=device)
    return w


def bn_state(hidden, device, prefix: str = "mlp") -> dict:
    s = {}
    for i, h in enumerate(hidden):
        s[f"{prefix}.bn.{i}.mean"] = torch.zeros(h, device=device)
        s[f"{prefix}.bn.{i}.var"] = torch.ones(h, device=device)
    return s


def mlp(w, state, x, n_layers: int, *, train: bool, prefix: str = "mlp",
        with_scale: bool = False):
    """Dense, BatchNorm (batch statistics, biased variance, in training;
    the running ones otherwise), ReLU; then the head. Returns (B,), and
    with ``with_scale`` each row's |head input| x |head kernel| too: the
    size of the terms the logit sums, which bounds what rounding can move
    it by, however far they cancel."""
    for i in range(n_layers):
        x = x @ w[f"{prefix}.layers.{i}.kernel"] + w[f"{prefix}.layers.{i}.bias"]
        if train:
            mean = x.mean(dim=0)
            var = ((x - mean) ** 2).mean(dim=0)
        else:
            mean, var = state[f"{prefix}.bn.{i}.mean"], state[f"{prefix}.bn.{i}.var"]
        x = ((x - mean) / torch.sqrt(var + BN_EPS) * w[f"{prefix}.bn.{i}.scale"]
             + w[f"{prefix}.bn.{i}.bias"])
        x = torch.relu(x)
    head = w[f"{prefix}.head.kernel"]
    out = (x @ head + w[f"{prefix}.head.bias"])[:, 0]
    if with_scale:
        return out, torch.linalg.vector_norm(x, dim=1) * torch.linalg.norm(head)
    return out


def bce(logits, labels):
    """Mean binary cross-entropy from logits, in the overflow-free form."""
    y = labels.to(torch.float32)
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def expected_bits(gamma, tau, bits, freq_sum):
    """Eq. 10's penalty without lambda: sum_g (sum_i b_i p_gi) / s_g."""
    p = torch.softmax(gamma / tau, dim=-1)
    b = torch.tensor([float(x) for x in bits], device=gamma.device)
    return ((p @ b) / freq_sum).sum()


# -- the training steps -------------------------------------------------------

def train(loss_fn, weights: dict, batches, opt: dict, clip_norm: float,
          probe_after: int):
    """``len(batches)`` steps of global-norm clipping and Adam (the
    configuration's ``opt``) on ``weights`` (trainable float tensors,
    updated here). Returns each step's loss, each leaf's first clipped
    gradient norm, and each leaf's norm of change after ``probe_after``
    steps (from a copy of the start taken here)."""
    b1, b2, eps, lr = opt["b1"], opt["b2"], opt["eps"], opt["lr"]
    names = list(weights)
    start = {k: v.detach().clone() for k, v in weights.items()}
    m = {k: torch.zeros_like(v) for k, v in weights.items()}
    v2 = {k: torch.zeros_like(v) for k, v in weights.items()}
    losses, first, change = [], {}, {}
    for t, batch in enumerate(batches, start=1):
        live = {k: weights[k].detach().requires_grad_(True) for k in names}
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, [live[k] for k in names])
        losses.append(float(loss.detach()))
        del live, loss
        gnorm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
        scale = float(min(1.0, clip_norm / (float(gnorm) + 1e-12)))
        for k, g in zip(names, grads):
            g = g * scale
            if t == 1:
                first[k] = float(torch.linalg.vector_norm(g.double()))
            m[k].mul_(b1).add_((1 - b1) * g)
            v2[k].mul_(b2).add_((1 - b2) * g * g)
            upd = (m[k] / (1 - b1 ** t)) / (torch.sqrt(v2[k] / (1 - b2 ** t))
                                            + eps)
            weights[k] = weights[k] - lr * upd
        del grads
        if t == probe_after:
            change = {k: float(torch.linalg.vector_norm(
                (weights[k] - start[k]).double())) for k in names}
    return losses, first, change
