"""Analysis corpus: the standard serving fleet, built tiny.

The port of the reference's ``repro.analysis.corpus``, at its sizes. The
walk-level passes need real cells to walk, so the corpus builds the fleet
``launch.serve`` ships, at toy sizes: the packed DLRM score cells with
their lookup-split companions, the tiered hot/cold cells over a
``TieredTableStore`` at hot 0.3, and the LM decode and continuous-batching
decode cells with int8 KV caches.

Mesh policy: on a world of 4 ranks (``torch.distributed``, e.g. gloo ranks
started by ``scripts/staticcheck_torch.py --world 4``) the corpus serves on
a 2×2 ``("data", "model")`` mesh with the sharded lookups on, so SC204 and
the BC5xx budgets see the real collectives, and it adds the a2a variants
(``serve_p99_a2a``, ``tiered_p99_a2a``); in one process it serves on the
1×1 host mesh (every wrapper single-device, still full precision and
recompile coverage).

The corpus is built on the engine's device: the CUDA card unless the
caller names another (the tests pass ``"cpu"``). ``walk_cell`` runs a
registered cell's step once, eagerly, under an ``OpWalk`` — on the card
too, where the engine itself replays a captured graph.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.op_walk import OpWalk
from repro_torch.dist.mesh import host_mesh, use_mesh, world_size


def budget_name(key) -> str:
    """budgets.json key for one cell: ``arch/shape@batch`` — stable across
    device, mesh, bound-tensor and fingerprint churn, which move the
    ``CellKey`` but not the layout the budget bounds."""
    return f"{key.arch}/{key.shape.split('#')[0]}"


def corpus_mesh():
    """2×2 ``("data", "model")`` on a world of at least 4 ranks, else the
    host mesh (1×1 in one process)."""
    if world_size() >= 4:
        return host_mesh(n_data=2, n_model=2)
    return host_mesh()


def build_corpus(mesh=None, *, seed: int = 4, device=None):
    """Build and register the standard cell fleet at toy sizes on
    ``device`` (default: the CUDA card). Returns the ``Engine``; walk
    ``engine.registered_cells()`` for the cells."""
    from repro_torch.cache.tiers import TieredTableStore
    from repro_torch.data.synthetic import SyntheticCTR
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import build_engine, train_packed_dlrm
    from repro_torch.models.dlrm import DLRM
    from repro_torch.models.lm import LM, LMConfig
    from repro_torch.serve.cells import lm_decode_cell, lm_decode_slotted_cell

    device = resolve_device(device)
    mesh = mesh if mesh is not None else corpus_mesh()

    cfg, params, state, buffers, spec, res = train_packed_dlrm(
        field_vocabs=(150, 100, 120), train_steps=6, train_batch=128,
        d_embed=8, mlp_hidden=(16,), seed=seed, device=device)
    # as the reference's: the table's static meta is the cell's config
    # (cfg.comp_cfg, in the fingerprint), not a bound input
    buffers = dict(buffers, embedding={})
    freqs = SyntheticCTR(spec).expected_frequencies()
    store = TieredTableStore(res["packed_table"], res["packed_meta"], freqs,
                             0.3, device=device)
    engine = build_engine(cfg, params, state, buffers, p99_rows=64,
                          bulk_rows=256, store=store, mesh=mesh,
                          device=device)
    if engine.mesh.size > 1:
        # the a2a comms variants under their own shape names: BC501
        # budgets the all-to-all id/word shuffle apart from the psum merge
        engine.register_packed_model(
            "dlrm", DLRM, cfg, params, state, buffers,
            shapes={"serve_p99_a2a": 64}, lookup_split=False,
            shard_lookup=True, lookup_comms="a2a", bucket_capacity=16)
        engine.register_tiered_model(
            "dlrm", DLRM, cfg, params, state, buffers, store,
            shapes={"tiered_p99_a2a": 64}, shard_lookup=True,
            lookup_comms="a2a", bucket_capacity=16)

    lm_cfg = LMConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
                      head_dim=16, d_ff=64, vocab=50, remat=False)
    gen = torch.Generator(device=device).manual_seed(0)
    lm_params, lm_buffers = LM.init(gen, lm_cfg)
    engine.register(lm_decode_cell(lm_cfg, lm_params, lm_buffers,
                                   batch=4, max_len=8, arch="lm-tiny"))
    engine.register(lm_decode_slotted_cell(lm_cfg, lm_params, lm_buffers,
                                           batch=2, max_len=8,
                                           arch="lm-cb"))
    return engine


#: cell kinds whose walks carry packed/quantized table codes as int32 —
#: PF102 widens its narrow set for these (see analysis.precision).
PACKED_KINDS = frozenset({"score", "lookup", "tiered_score"})


def is_packed(celldef) -> bool:
    return celldef.kind in PACKED_KINDS


def request_inputs(celldef, device):
    """Zeroed request inputs of a cell on ``device`` (id 0, an empty cold
    buffer); a tree of inputs (a decode cell's KV caches) from its
    ``make_request_state``."""
    out = []
    for spec in celldef.request_specs:
        if isinstance(spec, dict):
            out.append(celldef.make_request_state(device=device))
        else:
            shape, dtype = spec
            out.append(torch.zeros(shape, dtype=dtype, device=device))
    return tuple(out)


def walk_cell(reg, mesh, device) -> OpWalk:
    """The op walk of one run of a registered cell's step over zeroed
    request inputs, under the engine's mesh — the step the cache captured
    (or runs eager), with the bound tensors it reads."""
    celldef = reg.celldef
    request = request_inputs(celldef, device)
    with use_mesh(mesh), torch.inference_mode(), OpWalk() as w:
        celldef.step_fn(*celldef.bound, *request)
    return w
