"""Dry-run cell construction: (arch × shape × mesh) → a step on meta tensors.

The port of the reference's ``repro.launch.cells``. A ``Cell`` bundles the
step function, **meta-device** input stand-ins (``torch.empty(...,
device="meta")``: shapes and dtypes, never allocated) and the in/out
partition specs of the production mesh from ``repro_torch.dist.sharding``.
Training cells run the whole train step (loss, gradient, the in-place Adam
pass); serve cells the model's serving computation — decode steps for
``decode_*``/``long_*``, packed-table scoring for recsys serving.

Shape cells follow the reference's exactly:
  LM:     train_4k (256×4096) · prefill_32k (32×32768) · decode_32k
          (128 @ 32768 KV) · long_500k (1 @ 524288 KV)
  GNN:    full_graph_sm · minibatch_lg (fanout 15-10 sampler shapes) ·
          ogb_products · molecule
  recsys: train_batch (65536) · serve_p99 (512) · serve_bulk (262144) ·
          retrieval_cand (1 × 1,048,576)

The stand-ins hold the reference's shapes (the port keeps packed words as
int32 where the reference holds uint32). They are made without touching a
full-size host array: models are initialized under ``meta_init``, which
sends every tensor factory to the meta device, and a recsys model at one
id a field, its vocabulary-sized leaves (the MPE table, γ, the group map,
Wide & Deep's wide weights, a packed table) replaced by stand-ins of the
full vocabulary, as the reference's cells spell them out.

The port has no partitioner: a cell's step is what **one rank** runs on
the production mesh in eager SPMD, which ``localize`` (when set) maps the
stand-ins to. It places what the port places:

  recsys train   the MPE table's leaves row-sharded over every axis (the
                 Trainer's ``table_rows_axes``), the batch data-parallel
                 inside ``sharded_value_and_grad``;
  DLRM serve     the packed table's row blocks on the rank
                 (``place_table_rows``), the sharded psum lookup;
  LM train       data-parallel over every axis, the token table's rows
                 over "model" (the Trainer's default);
  the rest       whole on every rank: the port's LM serving, GIN, and
                 the towers and sequence models' serving have no mesh
                 placement.

The declared specs are the reference's; where the port places less, the
dry run's per-device numbers show it.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs.base import get_arch
from repro_torch.core.inference import packed_specs
from repro_torch.core.mpe import MPEConfig
from repro_torch.dist.shard import (active_mesh, local_row_block,
                                    place_table_rows, sharded_value_and_grad,
                                    table_shard_flags)
from repro_torch.dist.sharding import (P, dp_axes, lm_batch_pspecs,
                                       lm_kv_cache_pspecs, lm_logits_pspecs,
                                       lm_param_pspecs, packed_serve_pspecs,
                                       recsys_table_pspecs, replicate_like)
from repro_torch.embeddings.table import FieldSpec
from repro_torch.serve.cells import packed_score_step
from repro_torch.train.optimizer import adam
from repro_torch.train.tree import leaves, unflatten

PACKED_HIST = (0.0, 0.30, 0.20, 0.20, 0.10, 0.10, 0.10)  # widths 0..6
META = torch.device("meta")


class Cell(NamedTuple):
    name: str
    step_fn: Callable
    input_specs: tuple       # meta tensors (trees of them), global shapes
    in_pspecs: tuple
    out_pspecs: Any
    meta: dict
    localize: Callable | None = None   # global stand-ins -> one rank's


def sds(shape, dtype) -> torch.Tensor:
    """A stand-in: a meta tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


class _OnMeta(TorchFunctionMode):
    """Every tensor factory and device move goes to the meta device."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = META
        elif func in _FACTORIES:
            kwargs["device"] = META
        if func is torch.Tensor.to:
            args = tuple(META if isinstance(a, (torch.device, str)) else a
                         for a in args)
        return func(*args, **kwargs)


_FACTORIES = {torch.zeros, torch.ones, torch.empty, torch.full, torch.randn,
              torch.rand, torch.randint, torch.arange, torch.tensor,
              torch.eye, torch.linspace, torch.as_tensor, torch.normal,
              torch.randperm}


def meta_init(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with every tensor it makes on the meta
    device (random draws take a CPU generator and make no data)."""
    with _OnMeta():
        return fn(*args, **kwargs)


def _opt_state(params):
    """The Adam state of ``params`` (the port's ``adam().init``) on meta."""
    return meta_init(adam(1e-3).init, params)


def _opt_pspecs(p_pspecs):
    return {"step": P(), "mu": p_pspecs, "nu": p_pspecs}


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

LM_SHAPE_DEFS = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1, long=True),
}


def apply_overrides(cfg, overrides):
    """NamedTuple config overrides ('moe.x' targets the nested MoEConfig)."""
    if not overrides:
        return cfg
    direct = {k: v for k, v in overrides.items()
              if "." not in k and k in cfg._fields}
    cfg = cfg._replace(**direct)
    moe_over = {k.split(".", 1)[1]: v for k, v in overrides.items()
                if k.startswith("moe.")}
    if moe_over and getattr(cfg, "moe", None) is not None:
        cfg = cfg._replace(moe=cfg.moe._replace(**moe_over))
    return cfg


def _train_step(loss, *, rows_axes, plain_vag: bool = False):
    """The train step of ``loss(params, buffers, state, batch) -> (loss,
    aux)``: the gradient, then the in-place Adam pass (scale 1, skipped on
    a non-finite loss). On a mesh of more than one rank (the dry run's)
    the gradient is ``sharded_value_and_grad``'s — the batch
    data-parallel, the table leaves ``table_shard_flags`` marks as the
    rank's row blocks, which ``localize`` cut — unless ``plain_vag``."""
    opt = adam(1e-3)

    def step(params, opt_state, state, buffers, batch):
        mesh = None if plain_vag else active_mesh()
        if mesh is None:
            flat = [p.detach().requires_grad_(True) for p in leaves(params)]
            with torch.enable_grad():
                value, aux = loss(unflatten(params, flat), buffers, state,
                                  batch)
                grads = list(torch.autograd.grad(value, flat))
        else:
            flags = params.flags     # the rank's view, from ``localize``
            vag = sharded_value_and_grad(
                lambda p, b, s, x, step: loss(p, b, s, x), mesh,
                rows_axes=rows_axes, flags=flags)
            (value, aux), grads = vag(params, buffers, state, batch,
                                      step=None)
        one = torch.ones((), dtype=torch.float32, device=value.device)
        ok = torch.isfinite(value)
        opt.update_(params, unflatten(params, grads), opt_state, one, ok)
        new_state = aux[0] if isinstance(aux, tuple) else state
        return params, opt_state, new_state, value.detach()
    return step


class _Local(dict):
    """A param dict holding the rank's row blocks, with the marks of the
    whole tree (``table_shard_flags``) it was cut from."""
    flags: list


def _localize_tables(params, opt_state, mesh, rows_axes):
    """The rank's view of a train cell's params and Adam moments: each
    leaf ``table_shard_flags`` marks cut to its row block (a view)."""
    flags = table_shard_flags(params, mesh, rows_axes)
    rows_ax = tuple(a for a in rows_axes if a in mesh.shape)
    n, me = mesh.axes_size(rows_ax), mesh.axis_index(rows_ax)

    def cut(tree):
        return unflatten(tree, [local_row_block(x, me, n) if f else x
                                for x, f in zip(leaves(tree), flags)])
    local = _Local(cut(params))
    local.flags = flags
    opt = dict(opt_state, mu=cut(opt_state["mu"]), nu=cut(opt_state["nu"]))
    return local, opt


def build_lm_cell(arch_id: str, shape: str, multi_pod: bool,
                  overrides=None) -> Cell:
    from repro_torch.models.lm import LM
    spec = get_arch(arch_id)
    cfg = apply_overrides(spec.make_config(False), overrides)
    sd = LM_SHAPE_DEFS[shape]
    dp = dp_axes(multi_pod)
    params, buffers = meta_init(LM.init, torch.Generator(), cfg)
    p_pspecs = lm_param_pspecs(params, cfg)

    if sd["kind"] == "train":
        opt_sds = _opt_state(params)
        batch_sds = {"tokens": sds((sd["batch"], sd["seq"]), torch.int32),
                     "labels": sds((sd["batch"], sd["seq"]), torch.int32)}
        rows_axes = ("model",)
        inner = _train_step(
            lambda p, b, s, x: (LM.loss_fn(p, b, x, cfg)[0], s),
            rows_axes=rows_axes)

        def train_step(params, opt_state, batch):
            p, o, _, loss = inner(params, opt_state, {}, buffers, batch)
            return p, o, loss

        def localize(inputs):
            p, o = _localize_tables(inputs[0], inputs[1],
                                    _MESH[multi_pod](), rows_axes)
            return p, o, inputs[2]

        return Cell(
            name=f"{arch_id}/{shape}", step_fn=train_step,
            input_specs=(params, opt_sds, batch_sds),
            in_pspecs=(p_pspecs, _opt_pspecs(p_pspecs),
                       lm_batch_pspecs(multi_pod)),
            out_pspecs=(p_pspecs, _opt_pspecs(p_pspecs), P()),
            meta={"kind": "train", "tokens": sd["batch"] * sd["seq"],
                  "family": "lm", "placement": "data-parallel over every "
                  "axis; token-table rows over model"},
            localize=localize)

    kv_int8 = bool((overrides or {}).get("kv_int8"))
    kv_dtype = torch.int8 if kv_int8 else torch.bfloat16
    cache_ps = lm_kv_cache_pspecs(quantized=kv_int8,
                                  long_context=sd.get("long", False),
                                  multi_pod=multi_pod)
    caches_sds = LM.make_kv_caches(cfg, sd["batch"], sd["seq"], kv_dtype,
                                   device=META)
    if sd["kind"] == "prefill":
        tokens_sds = sds((sd["batch"], sd["seq"]), torch.int32)

        def prefill_step(params, tokens):
            return LM.prefill(params, buffers, tokens, cfg, max_len=sd["seq"])

        return Cell(
            name=f"{arch_id}/{shape}", step_fn=prefill_step,
            input_specs=(params, tokens_sds),
            in_pspecs=(p_pspecs, P(dp, None)),
            out_pspecs=(lm_logits_pspecs(sd["batch"], vocab_sharded=True,
                                         dp=dp), cache_ps),
            meta={"kind": "prefill", "tokens": sd["batch"] * sd["seq"],
                  "family": "lm", "placement": "whole on every rank"})

    tok_batch_ps = P(dp, None) if sd["batch"] > 1 else P(None, None)
    tokens_sds = sds((sd["batch"], 1), torch.int32)

    def decode_step(params, tokens, caches):
        return LM.decode_step(params, buffers, tokens, caches, cfg)

    return Cell(
        name=f"{arch_id}/{shape}", step_fn=decode_step,
        input_specs=(params, tokens_sds, caches_sds),
        in_pspecs=(p_pspecs, tok_batch_ps, cache_ps),
        out_pspecs=(lm_logits_pspecs(sd["batch"], dp=dp), cache_ps),
        meta={"kind": "decode", "tokens": sd["batch"], "family": "lm",
              "kv_len": sd["seq"], "placement": "whole on every rank"})


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

def build_gnn_cell(arch_id: str, shape: str, multi_pod: bool) -> Cell:
    from repro_torch.configs.gin_tu import GRAPH_CELLS
    from repro_torch.data.graphs import NeighborSampler
    from repro_torch.models.gnn import GIN
    spec = get_arch(arch_id)
    cfg = spec.make_config(False, shape=shape)
    cell = GRAPH_CELLS[shape]
    dp = dp_axes(multi_pod)
    edge_ax = (*dp, "model")

    if shape == "minibatch_lg":
        n_nodes, n_edges = NeighborSampler.output_sizes(cell.batch_nodes,
                                                        cell.fanout)
    elif shape == "molecule":
        n_nodes = cell.n_graphs * cell.n_nodes
        n_edges = cell.n_graphs * cell.n_edges
    else:
        n_nodes, n_edges = cell.n_nodes, cell.n_edges
    # the edge list padded to the full mesh size (512 covers both meshes);
    # padded edges carry edge_mask = False
    n_edges = -(-n_edges // 512) * 512

    graph_sds = {
        "edge_src": sds((n_edges,), torch.int32),
        "edge_dst": sds((n_edges,), torch.int32),
        "edge_mask": sds((n_edges,), torch.bool),
        "labels": sds((cell.n_graphs if cfg.readout == "graph" else n_nodes,),
                      torch.int32),
    }
    graph_ps = {"edge_src": P(edge_ax), "edge_dst": P(edge_ax),
                "edge_mask": P(edge_ax), "labels": P(None)}
    n_graphs = 0
    if cfg.input_mode == "categorical":
        graph_sds["atom_ids"] = sds((n_nodes,), torch.int32)
        graph_sds["graph_ids"] = sds((n_nodes,), torch.int32)
        graph_ps["atom_ids"] = P(None)
        graph_ps["graph_ids"] = P(None)
        n_graphs = cell.n_graphs
    else:
        graph_sds["x"] = sds((n_nodes, cell.d_feat), torch.float32)
        graph_ps["x"] = P(None, None)
    if shape == "minibatch_lg":
        graph_sds["label_mask"] = sds((n_nodes,), torch.float32)
        graph_ps["label_mask"] = P(None)

    params, buffers = meta_init(GIN.init, cfg, seed=0, device="cpu")
    p_pspecs = replicate_like(params)
    bufs_pspecs = replicate_like(buffers)
    opt_sds = _opt_state(params)
    inner = _train_step(
        lambda p, b, s, g: (GIN.loss_fn(p, b, g, cfg, lam=1e-5)[0], s),
        rows_axes=(), plain_vag=True)

    def train_step(params, opt_state, buffers, graph):
        if n_graphs:
            graph = dict(graph, n_graphs=n_graphs)
        p, o, _, loss = inner(params, opt_state, {}, buffers, graph)
        return p, o, loss

    return Cell(
        name=f"{arch_id}/{shape}", step_fn=train_step,
        input_specs=(params, opt_sds, buffers, graph_sds),
        in_pspecs=(p_pspecs, _opt_pspecs(p_pspecs), bufs_pspecs, graph_ps),
        out_pspecs=(p_pspecs, _opt_pspecs(p_pspecs), P()),
        meta={"kind": "train", "family": "gnn", "n_edges": n_edges,
              "n_nodes": n_nodes, "placement": "whole on every rank"})


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

RECSYS_BATCH = {"train_batch": 65536, "serve_p99": 512, "serve_bulk": 262144,
                "retrieval_cand": 1}
N_CANDIDATES = 1_048_576
SERVE_CANDS = 1000  # candidate set for sasrec online scoring


def _mpe_param_specs(n: int, d: int, m: int = 7, group_size: int = 128):
    g = -(-n // group_size)
    return {"emb": sds((n, d), torch.float32),
            "gamma": sds((g, m), torch.float32),
            "alpha": sds((m,), torch.float32),
            "beta": sds((d,), torch.float32)}


def _mpe_buffer_specs(n: int, group_size: int = 128):
    g = -(-n // group_size)
    return {"group_of_feature": sds((n,), torch.int32),
            "freq_sum": sds((g,), torch.float32)}


def _packed_param_specs(n, d):
    return packed_specs(n, d, MPEConfig(), PACKED_HIST)


def _packed_cfg(n, d):
    return {"bits": MPEConfig().bits, "d": d, "n": n}


def _one_id_a_field(cfg):
    """``cfg`` with every vocabulary one id: the model's other leaves keep
    their shapes, its vocabulary-sized ones are replaced afterwards."""
    out = {}
    for k in ("fields", "user_fields", "item_fields", "ctx_fields"):
        if k in cfg._fields:
            out[k] = tuple(FieldSpec(f.name, 1) for f in getattr(cfg, k))
    if "item_vocab" in cfg._fields:
        out["item_vocab"] = 1
    return cfg._replace(**out)


def _init_small(model, cfg, **over):
    """(params, buffers, state) of ``model`` at one id a field, on meta."""
    small = _one_id_a_field(cfg)._replace(**over)
    return meta_init(model.init, small, seed=0, device="cpu")


def _vocab_leaves(params, n):
    """Wide & Deep's wide weights and DeepFM's first-order weights: one a
    feature."""
    for k in ("wide", "fm_linear"):
        if k in params:
            params[k] = sds((n,), params[k].dtype)
    return params


def build_recsys_cell(arch_id: str, shape: str, multi_pod: bool,
                      overrides=None) -> Cell:
    spec = get_arch(arch_id)
    dp = dp_axes(multi_pod)
    rows_axes = (*dp, "model")
    overrides = overrides or {}
    if overrides.get("table_model_only"):
        rows_axes = ("model",)
    builder = {"wide-deep": _flat_ctr_cell, "dlrm-criteo": _flat_ctr_cell,
               "two-tower-retrieval": _two_tower_cell, "bst": _bst_cell,
               "sasrec": _sasrec_cell}[arch_id]
    return builder(spec, shape, RECSYS_BATCH[shape], shape == "train_batch",
                   dp, rows_axes, multi_pod, overrides)


def _train_cell(name, model_loss, params, buffers, state, p_pspecs,
                bufs_pspecs, st_pspecs, batch_sds, batch_ps, meta, *,
                rows_axes, multi_pod, overrides):
    moment_dtype = torch.bfloat16 if overrides.get("bf16_moments") else None
    opt_sds = meta_init(adam(1e-3, moment_dtype=moment_dtype).init, params)
    step = _train_step(model_loss, rows_axes=rows_axes)

    def localize(inputs):
        p, o = _localize_tables(inputs[0], inputs[1], _MESH[multi_pod](),
                                rows_axes)
        return (p, o, *inputs[2:])

    return Cell(
        name=name, step_fn=step,
        input_specs=(params, opt_sds, state, buffers, batch_sds),
        in_pspecs=(p_pspecs, _opt_pspecs(p_pspecs), st_pspecs, bufs_pspecs,
                   batch_ps),
        out_pspecs=(p_pspecs, _opt_pspecs(p_pspecs), st_pspecs, P()),
        meta=dict(meta, placement="MPE table rows over "
                  f"{'x'.join(rows_axes)}; batch data-parallel"),
        localize=localize)


def _serve_cell(name, serve_fn, inputs, inputs_ps, out_ps, meta,
                localize=None):
    return Cell(name=name, step_fn=serve_fn, input_specs=inputs,
                in_pspecs=inputs_ps, out_pspecs=out_ps, meta=meta,
                localize=localize)


def _train_pspecs(params, buffers, state, rows_axes):
    p_pspecs = replicate_like(params)
    p_pspecs["embedding"] = recsys_table_pspecs(rows_axes)
    for k in ("wide", "fm_linear"):
        if k in params:
            p_pspecs[k] = P(rows_axes)
    bufs_pspecs = replicate_like(buffers)
    bufs_pspecs["embedding"] = {"group_of_feature": P(rows_axes),
                                "freq_sum": P(None)}
    return p_pspecs, bufs_pspecs, replicate_like(state)


def _packed_params(model, cfg, n, d):
    """A serving model's params with its packed table stand-in, and its
    buffers and state (the table's meta is the cell's config)."""
    params, buffers, state = _init_small(model, cfg, compressor="plain",
                                         comp_cfg=None)
    params = _vocab_leaves(dict(params, embedding=_packed_param_specs(n, d)), n)
    return params, dict(buffers, embedding={}), state


# -- wide-deep / dlrm (flat multi-field CTR) --------------------------------

def _flat_ctr_cell(spec, shape, batch, train, dp, rows_axes, multi_pod,
                   overrides):
    from repro_torch.models.dlrm import DLRM
    from repro_torch.models.wide_deep import WideDeep
    model = WideDeep if spec.arch_id == "wide-deep" else DLRM
    base = spec.make_config(False)
    fields = base.fields
    n = int(sum(f.vocab for f in fields))
    d = base.d_embed
    if train:
        cfg = base._replace(compressor="mpe_search", comp_cfg=None)
        params, buffers, state = _init_small(model, cfg)
        params = _vocab_leaves(dict(params,
                                    embedding=_mpe_param_specs(n, d)), n)
        buffers = dict(buffers, embedding=_mpe_buffer_specs(n))
        p_ps, b_ps, s_ps = _train_pspecs(params, buffers, state, rows_axes)
        batch_sds = {"ids": sds((batch, len(fields)), torch.int32),
                     "label": sds((batch,), torch.int32)}
        batch_ps = {"ids": P(dp, None), "label": P(dp)}

        def loss(p, bu, st, b):
            return model.loss_fn(p, bu, st, b, cfg, lam=1e-5, train=True)

        return _train_cell(f"{spec.arch_id}/{shape}", loss, params, buffers,
                           state, p_ps, b_ps, s_ps, batch_sds, batch_ps,
                           {"kind": "train", "family": "recsys", "rows": n,
                            "batch": batch}, rows_axes=rows_axes,
                           multi_pod=multi_pod, overrides=overrides)

    cfg = base._replace(compressor="packed", comp_cfg=_packed_cfg(n, d))
    n_eff = N_CANDIDATES if shape == "retrieval_cand" else batch
    params, buffers, state = _packed_params(model, cfg, n, d)
    p_pspecs = packed_serve_pspecs(params, rows_axes=rows_axes)
    ids_sds = sds((n_eff, len(fields)), torch.int32)
    ids_ps = P(rows_axes if shape == "retrieval_cand" else dp, None)
    top_k = 100 if shape == "retrieval_cand" else None
    sharded = model is DLRM     # only DLRM's lookup is sharded on a mesh
    serve_step = packed_score_step(model, cfg, top_k=top_k,
                                   shard_lookup=sharded, rows_axes=rows_axes,
                                   row_blocks=sharded)
    localize = None
    if sharded:
        def localize(inputs):
            p = dict(inputs[0], embedding=place_table_rows(
                inputs[0]["embedding"], _MESH[multi_pod](), rows_axes))
            return (p, *inputs[1:])
    return _serve_cell(
        f"{spec.arch_id}/{shape}", serve_step,
        (params, state, buffers, ids_sds),
        (p_pspecs, replicate_like(state), replicate_like(buffers), ids_ps),
        (P(None), P(None)) if shape == "retrieval_cand" else P(dp),
        {"kind": "serve", "family": "recsys", "rows": n, "batch": n_eff,
         "placement": ("packed table rows over " + "x".join(rows_axes)
                       + "; psum lookup" if sharded
                       else "whole on every rank")},
        localize)


# -- two-tower ---------------------------------------------------------------

def _two_tower_cell(spec, shape, batch, train, dp, rows_axes, multi_pod,
                    overrides):
    from repro_torch.models.two_tower import TwoTower
    base = spec.make_config(False)
    fields = (*base.user_fields, *base.item_fields)
    n = int(sum(f.vocab for f in fields))
    d = base.d_embed
    fu, fi = len(base.user_fields), len(base.item_fields)

    if train:
        cfg = base._replace(compressor="mpe_search", comp_cfg=None)
        params, buffers, state = _init_small(TwoTower, cfg)
        params = dict(params, embedding=_mpe_param_specs(n, d))
        buffers = dict(buffers, embedding=_mpe_buffer_specs(n))
        p_ps, b_ps, s_ps = _train_pspecs(params, buffers, state, rows_axes)
        batch_sds = {"user_ids": sds((batch, fu), torch.int32),
                     "item_ids": sds((batch, fi), torch.int32),
                     "item_logq": sds((batch,), torch.float32)}
        batch_ps = {"user_ids": P(dp, None), "item_ids": P(dp, None),
                    "item_logq": P(dp)}

        def loss(p, bu, st, b):
            return TwoTower.loss_fn(p, bu, st, b, cfg, lam=1e-5, train=True)

        return _train_cell(f"{spec.arch_id}/{shape}", loss, params, buffers,
                           state, p_ps, b_ps, s_ps, batch_sds, batch_ps,
                           {"kind": "train", "family": "recsys", "rows": n,
                            "batch": batch}, rows_axes=rows_axes,
                           multi_pod=multi_pod, overrides=overrides)

    scfg = base._replace(compressor="packed", comp_cfg=_packed_cfg(n, d))
    params, buffers, state = _packed_params(TwoTower, scfg, n, d)
    p_pspecs = packed_serve_pspecs(params, rows_axes=rows_axes)
    common = (p_pspecs, replicate_like(state), replicate_like(buffers))
    whole = {"kind": "serve", "family": "recsys", "rows": n,
             "placement": "whole on every rank"}

    if shape == "retrieval_cand":
        def serve_step(params, state, buffers, user_ids, cand_ids):
            return TwoTower.retrieval_score(params, buffers, state, user_ids,
                                            cand_ids, scfg, top_k=100)

        return _serve_cell(
            f"{spec.arch_id}/{shape}", serve_step,
            (params, state, buffers, sds((1, fu), torch.int32),
             sds((N_CANDIDATES, fi), torch.int32)),
            (*common, P(None, None), P(rows_axes, None)),
            (P(None), P(None)), dict(whole, batch=N_CANDIDATES))

    def serve_step(params, state, buffers, user_ids, item_ids):
        u, _ = TwoTower.user_tower(params, buffers, state, user_ids, scfg)
        v, _ = TwoTower.item_tower(params, buffers, state, item_ids, scfg)
        return torch.sum(u * v, dim=-1)

    return _serve_cell(
        f"{spec.arch_id}/{shape}", serve_step,
        (params, state, buffers, sds((batch, fu), torch.int32),
         sds((batch, fi), torch.int32)),
        (*common, P(dp, None), P(dp, None)), P(dp), dict(whole, batch=batch))


# -- bst ----------------------------------------------------------------------

def _bst_cell(spec, shape, batch, train, dp, rows_axes, multi_pod,
              overrides):
    from repro_torch.models.bst import BST
    base = spec.make_config(False)
    n = base.item_vocab + sum(f.vocab for f in base.ctx_fields)
    d = base.d_embed
    fc = len(base.ctx_fields)
    s = base.seq_len

    if train:
        cfg = base._replace(compressor="mpe_search", comp_cfg=None)
        params, buffers, state = _init_small(BST, cfg)
        params = dict(params, embedding=_mpe_param_specs(n, d))
        buffers = dict(buffers, embedding=_mpe_buffer_specs(n))
        p_ps, b_ps, s_ps = _train_pspecs(params, buffers, state, rows_axes)
        batch_sds = {"seq_ids": sds((batch, s), torch.int32),
                     "target_id": sds((batch,), torch.int32),
                     "ctx_ids": sds((batch, fc), torch.int32),
                     "label": sds((batch,), torch.int32)}
        batch_ps = {"seq_ids": P(dp, None), "target_id": P(dp),
                    "ctx_ids": P(dp, None), "label": P(dp)}

        def loss(p, bu, st, b):
            return BST.loss_fn(p, bu, st, b, cfg, lam=1e-5, train=True)

        return _train_cell(f"{spec.arch_id}/{shape}", loss, params, buffers,
                           state, p_ps, b_ps, s_ps, batch_sds, batch_ps,
                           {"kind": "train", "family": "recsys", "rows": n,
                            "batch": batch}, rows_axes=rows_axes,
                           multi_pod=multi_pod, overrides=overrides)

    scfg = base._replace(compressor="packed", comp_cfg=_packed_cfg(n, d))
    params, buffers, state = _packed_params(BST, scfg, n, d)
    p_pspecs = packed_serve_pspecs(params, rows_axes=rows_axes)
    n_eff = N_CANDIDATES if shape == "retrieval_cand" else batch
    row_ax = rows_axes if shape == "retrieval_cand" else dp
    batch_sds = {"seq_ids": sds((n_eff, s), torch.int32),
                 "target_id": sds((n_eff,), torch.int32),
                 "ctx_ids": sds((n_eff, fc), torch.int32),
                 "label": sds((n_eff,), torch.int32)}
    batch_ps = {"seq_ids": P(row_ax, None), "target_id": P(row_ax),
                "ctx_ids": P(row_ax, None), "label": P(row_ax)}

    def serve_step(params, state, buffers, batch_in):
        logits = BST.apply(params, buffers, state, batch_in, scfg,
                           train=False)[0]
        if shape == "retrieval_cand":
            return tuple(torch.topk(logits, 100))
        return logits

    return _serve_cell(
        f"{spec.arch_id}/{shape}", serve_step,
        (params, state, buffers, batch_sds),
        (p_pspecs, replicate_like(state), replicate_like(buffers), batch_ps),
        (P(None), P(None)) if shape == "retrieval_cand" else P(row_ax),
        {"kind": "serve", "family": "recsys", "rows": n, "batch": n_eff,
         "placement": "whole on every rank"})


# -- sasrec -------------------------------------------------------------------

def _sasrec_cell(spec, shape, batch, train, dp, rows_axes, multi_pod,
                 overrides):
    from repro_torch.models.sasrec import SASRec
    base = spec.make_config(False)
    n, d, s = base.item_vocab, base.d_embed, base.seq_len

    if train:
        cfg = base._replace(compressor="mpe_search", comp_cfg=None)
        params, buffers, _ = _init_small(SASRec, cfg)
        params = dict(params, embedding=_mpe_param_specs(n, d))
        buffers = {"embedding": _mpe_buffer_specs(n)}
        p_ps, b_ps, _ = _train_pspecs(params, buffers, {}, rows_axes)
        batch_sds = {k: sds((batch, s), torch.int32)
                     for k in ("seq_ids", "pos_ids", "neg_ids")}
        batch_sds["mask"] = sds((batch, s), torch.float32)
        batch_ps = {k: P(dp, None)
                    for k in ("seq_ids", "pos_ids", "neg_ids", "mask")}

        def loss(p, bu, st, b):
            return SASRec.loss_fn(p, bu, st, b, cfg, lam=1e-5, train=True)

        return _train_cell(f"{spec.arch_id}/{shape}", loss, params, buffers,
                           {}, p_ps, b_ps, {}, batch_sds, batch_ps,
                           {"kind": "train", "family": "recsys", "rows": n,
                            "batch": batch}, rows_axes=rows_axes,
                           multi_pod=multi_pod, overrides=overrides)

    scfg = base._replace(compressor="packed", comp_cfg=_packed_cfg(n, d))
    params, _, _ = _init_small(SASRec, scfg, compressor="plain",
                               comp_cfg=None)
    params = dict(params, embedding=_packed_param_specs(n, d))
    p_pspecs = packed_serve_pspecs(params, rows_axes=rows_axes)
    buffers = {"embedding": {}}
    whole = {"kind": "serve", "family": "recsys", "rows": n,
             "placement": "whole on every rank"}

    def serve_step(params, buffers, seq_ids, cand_ids):
        return SASRec.score_candidates(params, buffers, seq_ids, cand_ids,
                                       scfg, top_k=100)

    if shape == "retrieval_cand":
        return _serve_cell(
            f"{spec.arch_id}/{shape}", serve_step,
            (params, buffers, sds((1, s), torch.int32),
             sds((N_CANDIDATES,), torch.int32)),
            (p_pspecs, {"embedding": {}}, P(None, None), P(rows_axes)),
            (P(None, None), P(None, None)), dict(whole, batch=N_CANDIDATES))
    return _serve_cell(
        f"{spec.arch_id}/{shape}", serve_step,
        (params, buffers, sds((batch, s), torch.int32),
         sds((SERVE_CANDS,), torch.int32)),
        (p_pspecs, {"embedding": {}}, P(dp, None), P(None)),
        (P(dp, None), P(dp, None)), dict(whole, batch=batch))


# ---------------------------------------------------------------------------

def _production(multi_pod: bool):
    from repro_torch.launch.mesh import production_dry_mesh
    return lambda: production_dry_mesh(multi_pod=multi_pod)


_MESH = {False: _production(False), True: _production(True)}


def build_cell(arch_id: str, shape: str, multi_pod: bool = False,
               overrides=None) -> Cell:
    spec = get_arch(arch_id)
    if spec.family == "lm":
        return build_lm_cell(arch_id, shape, multi_pod, overrides)
    if spec.family == "gnn":
        return build_gnn_cell(arch_id, shape, multi_pod)
    return build_recsys_cell(arch_id, shape, multi_pod, overrides)


def cell_shapes(arch_id: str) -> tuple:
    """The shape cells of an arch: its config's, or every recsys shape for
    a recsys arch (the reference's cells of ``dlrm-criteo`` include
    training, which the port's serving config does not list)."""
    from repro_torch.configs.base import RECSYS_SHAPES
    spec = get_arch(arch_id)
    return RECSYS_SHAPES if spec.family == "recsys" else tuple(spec.shapes)
