"""The plain reference of the BST configuration (Behavior Sequence
Transformer, arXiv:1905.06874: the user's item sequence plus the target
item through one post-LN transformer block with learned positions, the
flattened block output and the context fields' embeddings through the MLP
with BatchNorm), trained under the MPE search layer (arXiv:2409.20305,
Eqs. 9-10) over one table of items and context ids; and the benchmark's
inputs for it, made on the device from the seed. Nothing here imports the
program.
"""
from __future__ import annotations

import torch

from perfbench.reference import common as C

SALT_WEIGHTS, SALT_BATCHES = 1, 2
# the configuration at a CPU test's size
TINY = {"mlp_hidden": [32, 16], "item_vocab": 5000, "ctx_vocabs": [100, 50]}


class Model:
    """The BST configuration (a ``configs/*.json`` dict) on a device."""

    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.items = cfg["item_vocab"]
        self.ctx = list(cfg["ctx_vocabs"])
        self.n = self.items + sum(self.ctx)
        self.d = cfg["d_embed"]
        self.s = cfg["seq_len"] + 1
        self.heads = cfg["n_heads"]
        self.hd = cfg["head_dim"]
        self.bits = tuple(cfg["bits"])
        self.hidden = tuple(cfg["mlp_hidden"])
        self.item_cdf = C.zipf_cdfs([self.items], cfg["zipf_exponent"],
                                    self.device)
        self.ctx_offsets = self.items + C.field_offsets(self.ctx, self.device)

    def frequencies(self) -> torch.Tensor:
        """Expected lookups of each row in a sample: the sequence and the
        target draw items from Zipf, each context field one id uniformly."""
        items = C.zipf_pdf(self.item_cdf, [self.items]) * self.s
        ctx = [torch.full((v,), 1.0 / v, dtype=torch.float64,
                          device=self.device) for v in self.ctx]
        return torch.cat([items, *ctx])

    def weights(self, seed: int) -> dict:
        """The search's start: embeddings N(0, 3e-3), gamma 0, alpha at
        LSQ's start, beta 0, positions N(0, 0.02), glorot projections, unit
        LayerNorms, the MLP at its initializers."""
        gen = C.generator(seed, SALT_WEIGHTS, self.device)
        dev, d, width = self.device, self.d, self.heads * self.hd
        n_groups = -(-self.n // self.cfg["group_size"])
        w = {"embedding.emb": C.EMBED_STD * torch.randn(
                 (self.n, d), generator=gen, device=dev),
             "embedding.gamma": torch.zeros((n_groups, len(self.bits)),
                                            device=dev),
             "embedding.alpha": torch.tensor(
                 [C.init_alpha(C.EMBED_STD, b) for b in self.bits], device=dev),
             "embedding.beta": torch.zeros(d, device=dev),
             "pos": 0.02 * torch.randn((self.s, d), generator=gen, device=dev)}
        for blk in range(self.cfg["n_blocks"]):
            p = f"blocks.{blk}."
            for name, shape in (("wq", (d, width)), ("wk", (d, width)),
                                ("wv", (d, width)), ("wo", (width, d))):
                w[f"{p}attn.{name}.kernel"] = C.glorot(gen, *shape, dev)
            ff = self.cfg["transformer_ff"]
            w[f"{p}ff1.kernel"] = C.glorot(gen, d, ff, dev)
            w[f"{p}ff1.bias"] = torch.zeros(ff, device=dev)
            w[f"{p}ff2.kernel"] = C.glorot(gen, ff, d, dev)
            w[f"{p}ff2.bias"] = torch.zeros(d, device=dev)
            for ln in ("ln1", "ln2"):
                w[f"{p}{ln}.scale"] = torch.ones(d, device=dev)
                w[f"{p}{ln}.bias"] = torch.zeros(d, device=dev)
        w.update(C.mlp_weights(gen, (self.s + len(self.ctx)) * d,
                               self.hidden, dev))
        return w

    def batches(self, seed: int, count: int, rows: int,
                positive_rate: float) -> list:
        """Zipf histories and targets, uniform context ids, Bernoulli
        labels."""
        gen = C.generator(seed, SALT_BATCHES, self.device)
        out = []
        for _ in range(count):
            seq = C.draw_zipf(gen, self.item_cdf, [self.items],
                              rows * self.s).reshape(rows, self.s)
            ctx = torch.stack([torch.randint(0, v, (rows,), generator=gen,
                                             device=self.device)
                               for v in self.ctx], dim=1)
            label = (torch.rand(rows, generator=gen, device=self.device)
                     < positive_rate).to(torch.int32)
            out.append({"seq_ids": seq[:, :-1].to(torch.int32).contiguous(),
                        "target_id": seq[:, -1].to(torch.int32).contiguous(),
                        "ctx_ids": ctx.to(torch.int32), "label": label})
        return out

    @staticmethod
    def _layer_norm(x, scale, bias):
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + C.LN_EPS) * scale + bias

    def _block(self, w, p: str, x):
        b, s, _ = x.shape
        h, hd = self.heads, self.hd

        def proj(name):
            return (x @ w[f"{p}attn.{name}.kernel"]).reshape(b, s, h, hd)
        q, k, v = proj("wq"), proj("wk"), proj("wv")
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
        att = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)
        a = att.reshape(b, s, h * hd) @ w[f"{p}attn.wo.kernel"]
        x = self._layer_norm(x + a, w[f"{p}ln1.scale"], w[f"{p}ln1.bias"])
        f = torch.relu(x @ w[f"{p}ff1.kernel"] + w[f"{p}ff1.bias"])
        f = f @ w[f"{p}ff2.kernel"] + w[f"{p}ff2.bias"]
        return self._layer_norm(x + f, w[f"{p}ln2.scale"], w[f"{p}ln2.bias"])

    def loss(self, w, gof, freq_sum, batch):
        cfg = self.cfg
        p = torch.softmax(w["embedding.gamma"] / cfg["tau"], dim=-1)

        def lookup(gids):
            return C.mixture(w["embedding.emb"][gids], p[gof[gids]],
                             w["embedding.alpha"], w["embedding.beta"],
                             self.bits)
        seq = torch.cat([batch["seq_ids"], batch["target_id"][:, None]],
                        dim=1).long()
        x = lookup(seq) + w["pos"][None]
        for blk in range(cfg["n_blocks"]):
            x = self._block(w, f"blocks.{blk}.", x)
        ctx = lookup(batch["ctx_ids"].long() + self.ctx_offsets)
        feats = torch.cat([x.reshape(x.shape[0], -1),
                           ctx.reshape(ctx.shape[0], -1)], dim=-1)
        logits = C.mlp(w, None, feats, len(self.hidden), train=True)
        reg = C.expected_bits(w["embedding.gamma"], cfg["tau"], self.bits,
                              freq_sum)
        return C.bce(logits, batch["label"]) + cfg["lam"] * reg

    def train(self, seed: int, batches, *, tf32: bool = False):
        gof, freq_sum = C.make_groups(self.frequencies(),
                                      self.cfg["group_size"])
        w = self.weights(seed)
        with C.matmul_precision(tf32):
            return C.train(lambda live, b: self.loss(live, gof, freq_sum, b),
                           w, batches, self.cfg["optimizer"],
                           self.cfg["clip_norm"], len(batches))
