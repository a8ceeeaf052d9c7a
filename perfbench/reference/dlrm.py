"""The plain reference of the DLRM configurations (paper 5.1: one global
table over all fields, the MLP with BatchNorm and a sigmoid CTR head, the
"dnn" backbone), and the benchmark's own inputs for them: the weights,
the frequency prior, the training batches and the request pool, all made
on the device from the seed. Nothing here imports the program.

Training takes the MPE search layer (Eq. 9 over the candidate widths,
groups by frequency, the Eq. 10 penalty); serving takes the packed table's
semantics (each row at its width, LSQ+ dequantized, 0 at width 0).
"""
from __future__ import annotations

import torch

from perfbench.reference import common as C

SALT_WEIGHTS, SALT_BATCHES, SALT_REQUESTS, SALT_WIDTHS = 1, 2, 3, 4
# the configuration at a CPU test's size
TINY = {"mlp_hidden": [32, 16], "field_vocabs": [3000, 2000, 1000, 500]}


class Model:
    """One DLRM configuration (a ``configs/*.json`` dict) on a device."""

    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.vocabs = list(cfg["field_vocabs"])
        self.n = sum(self.vocabs)
        self.d = cfg["d_embed"]
        self.bits = tuple(cfg["bits"])
        self.hidden = tuple(cfg["mlp_hidden"])
        self.cdfs = C.zipf_cdfs(self.vocabs, cfg["zipf_exponent"], self.device)
        self.offsets = C.field_offsets(self.vocabs, self.device)

    # -- inputs ---------------------------------------------------------------
    def frequencies(self) -> torch.Tensor:
        """The frequency prior MPE groups by: each row's probability
        within its field (float64)."""
        return C.zipf_pdf(self.cdfs, self.vocabs)

    def weights(self, seed: int) -> dict:
        """The search's starting weights (paper 5.1.5): embeddings
        N(0, 3e-3), gamma 0 (uniform widths), alpha at LSQ's start, beta 0,
        the MLP at its initializers. Flat names, float32."""
        gen = C.generator(seed, SALT_WEIGHTS, self.device)
        n_groups = -(-self.n // self.cfg["group_size"])
        w = {"embedding.emb": C.EMBED_STD * torch.randn(
                 (self.n, self.d), generator=gen, device=self.device),
             "embedding.gamma": torch.zeros((n_groups, len(self.bits)),
                                            device=self.device),
             "embedding.alpha": torch.tensor(
                 [C.init_alpha(C.EMBED_STD, b) for b in self.bits],
                 device=self.device),
             "embedding.beta": torch.zeros(self.d, device=self.device)}
        w.update(C.mlp_weights(gen, len(self.vocabs) * self.d, self.hidden,
                               self.device))
        return w

    def served(self, seed: int) -> tuple:
        """A served model's weights: the master table with each feature's
        width (Eq. 11 over gamma drawn at 0.01 scale, as a searched table
        ends; the same widths for every seed, in the seed's order over the
        groups), and an MLP whose biases and BatchNorm statistics are drawn
        too, so that serving reads every one. Returns (weights, state,
        per-feature width index)."""
        w = self.weights(seed)
        # the groups' widths are one draw for every seed, dealt to the
        # groups in an order of the seed's: every seed's table packs to the
        # same sizes
        fixed = C.generator(0, SALT_WIDTHS, self.device)
        gamma = self.cfg["served_gamma_std"] * torch.randn(
            w["embedding.gamma"].shape, generator=fixed, device=self.device)
        gen = C.generator(seed, SALT_WIDTHS, self.device)
        group_widths = C.sample_widths(gamma, self.cfg["tau"], self.bits)[
            torch.randperm(gamma.shape[0], generator=gen, device=self.device)]
        gof, _ = C.make_groups(self.frequencies(), self.cfg["group_size"])
        widx = group_widths[gof]
        del gof, gamma, group_widths
        state = C.bn_state(self.hidden, self.device)
        for k in list(w):
            if k.startswith("mlp.") and k.endswith(".bias"):
                w[k] = 0.05 * torch.randn(w[k].shape, generator=gen,
                                          device=self.device)
        for k in list(state):
            if k.endswith(".mean"):
                state[k] = 0.1 * torch.randn(state[k].shape, generator=gen,
                                             device=self.device)
            else:
                state[k] = 0.5 + torch.rand(state[k].shape, generator=gen,
                                            device=self.device)
        return w, state, widx.to(torch.int32)

    def batches(self, seed: int, count: int, rows: int,
                positive_rate: float) -> list:
        """``count`` training batches of per-field local ids, Zipf per
        field, and Bernoulli labels."""
        gen = C.generator(seed, SALT_BATCHES, self.device)
        out = []
        for _ in range(count):
            gids = C.draw_zipf(gen, self.cdfs, self.vocabs, rows)
            label = (torch.rand(rows, generator=gen, device=self.device)
                     < positive_rate).to(torch.int32)
            out.append({"ids": (gids - self.offsets).to(torch.int32),
                        "label": label})
        return out

    def request_pool(self, seed: int, rows: int) -> torch.Tensor:
        """(rows, F) per-field local ids, Zipf per field: requests are
        slices of it."""
        gen = C.generator(seed, SALT_REQUESTS, self.device)
        gids = C.draw_zipf(gen, self.cdfs, self.vocabs, rows)
        return (gids - self.offsets).to(torch.int32)

    # -- the model ------------------------------------------------------------
    def loss(self, w, gof, freq_sum, batch):
        """The search loss: BCE of the MLP over the Eq. 9 mixture of every
        looked-up row, plus lambda times the Eq. 10 penalty."""
        cfg = self.cfg
        gids = batch["ids"].long() + self.offsets
        rows = w["embedding.emb"][gids]
        p = torch.softmax(w["embedding.gamma"] / cfg["tau"], dim=-1)
        emb = C.mixture(rows, p[gof[gids]], w["embedding.alpha"],
                        w["embedding.beta"], self.bits)
        logits = C.mlp(w, None, emb.reshape(emb.shape[0], -1),
                       len(self.hidden), train=True)
        reg = C.expected_bits(w["embedding.gamma"], cfg["tau"], self.bits,
                              freq_sum)
        return C.bce(logits, batch["label"]) + cfg["lam"] * reg

    def train(self, seed: int, batches, *, tf32: bool = False):
        """The search's first ``len(batches)`` steps from ``weights(seed)``:
        (losses, first gradient norms, change norms), by leaf name."""
        gof, freq_sum = C.make_groups(self.frequencies(),
                                      self.cfg["group_size"])
        w = self.weights(seed)
        with C.matmul_precision(tf32):
            return C.train(lambda live, b: self.loss(live, gof, freq_sum, b),
                           w, batches, self.cfg["optimizer"],
                           self.cfg["clip_norm"], len(batches))

    def logits(self, served: tuple, ids: torch.Tensor, *,
               tf32: bool = False) -> tuple:
        """Scores of (rows, F) per-field local ids under a served model, and
        each score's scale (``common.mlp``'s ``with_scale``)."""
        w, state, widx = served
        gids = ids.long() + self.offsets
        emb = C.dequantize(w["embedding.emb"][gids], widx[gids].long(),
                           w["embedding.alpha"], w["embedding.beta"],
                           self.bits)
        with C.matmul_precision(tf32), torch.no_grad():
            return C.mlp(w, state, emb.reshape(emb.shape[0], -1),
                         len(self.hidden), train=False, with_scale=True)
