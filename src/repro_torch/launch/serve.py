"""Serving launcher: drive the packed-table engine with a traffic mix.

Builds a DLRM whose embedding is the bit-packed mixed-precision table of
paper §4, the way the reference's ``Packed.init`` does (the search layer's
init, random γ scaled by 0.01, Eq. 11 sampling, the packed export) with
weights drawn from ``--seed`` and the Zipf frequency prior of
``SyntheticCTR``; or, with ``--train-steps N``, the table and MLP that the
MPE pipeline trains in N search and N retrain steps on that stream
(``train_packed_dlrm``, as the reference's launcher serves). It registers
the ``serve_p99`` and ``serve_bulk`` cells — captured once as CUDA graphs on
the card — sends ``--requests`` requests of ``--batch`` rows (padded onto
the p99 cell) and optionally one ``--bulk`` job, and prints per-cell p50/p99
latency in the Figure-5 lookup-vs-compute split.

``--qps`` switches to **open-loop** mode: request arrivals follow seeded
exponential inter-arrival times at the offered rate (arrivals don't wait for
service), and concurrent requests coalesce through the admission queue +
scheduler onto shared padded cells. The report then adds the per-request
queue-wait / batch-assembly / compute breakdown, shed counts and per-cell
occupancy.

``--repack-budget`` demonstrates **serving-time precision adaptation**
(``repro_torch.serve.repack``): halfway through the request stream (at the
open loop's first round with ``--qps``) the planner emits a new per-group
assignment at that fraction of the current packed payload bytes and the
swapper re-packs it and swaps it into the live cells in place — the run
asserts the swap compiled nothing. ``--repack-headroom`` packs the serving
table with spare per-width row capacity so demoted groups can land in
intermediate widths.

``--hot-frac`` also serves through a hot/cold ``TieredTableStore``
(``repro_torch.cache``) on the ``tiered_p99``/``tiered_bulk`` cells.
``--cache-policy decay`` turns the store's hit/miss stream into a
**traffic-adaptive hot set** (``repro_torch.cache.policy``): exponential-decay
admission scores plan bounded promotion/demotion batches every
``--policy-every`` scheduling rounds, applied in place — no re-pack, no
recapture. ``--drift``/``--shift-at`` make the request stream non-stationary
(``DriftingCTR``), and ``--writeback N`` interleaves writebacks of the
master embedding with live traffic.

``--mesh dp,mp`` (or ``pod,dp,mp``, or ``auto``) serves on a mesh of
``repro_torch.dist``: start one process per rank with
``torch.distributed.run``, which sets the environment
``init_distributed`` reads (or name ``--coordinator``, ``--num-hosts`` and
``--host-id``). Every rank serves the same requests; the packed and hot
gathers run on the sharded lookups (subtables row-sharded over "model",
requests over the other axes) and merge by ``--lookup-comms`` — ``psum``,
or ``a2a`` with ``--bucket-capacity`` ids a bucket — so every rank's scores
are the one-device scores, bit for bit. A sharded cell on a mesh of more
than one rank runs eager, not as a CUDA graph. Rank 0 writes ``--json``
and ``--scores``. A run that started its process group ends it
(``repro_torch.dist.mesh.launch_session``): every rank waits at a barrier,
then destroys the group.

Runs on the CUDA card unless ``--device`` names another:

    python -m repro_torch.launch.serve --arch dlrm-criteo --requests 20 --batch 300 --bulk 300000
    python -m repro_torch.launch.serve --qps 2000 --requests 200 --batch 300 --deadline-ms 20
    python -m repro_torch.launch.serve --reduced --device cpu --requests 20 --repack-budget 0.8 --repack-headroom 0.5
    python -m repro_torch.launch.serve --reduced --device cpu --qps 400 --requests 60 --batch 60 --hot-frac 0.2 --cache-policy decay --decay-halflife 16 --policy-every 2 --shift-at 20 --writeback 8
    python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.serve --reduced --device cpu --mesh 2,2 --lookup-comms a2a --bucket-capacity 4
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.cache.policy import DecayAdmissionPolicy, StaticTierPolicy
from repro_torch.cache.tiers import TieredTableStore
from repro_torch.configs.base import SERVE_ROWS, get_arch
from repro_torch.core.compressors import Packed, as_mpe_config
from repro_torch.core.inference import build_packed_table
from repro_torch.core.mpe import MPEConfig, make_groups
from repro_torch.core.pipeline import run_mpe_pipeline
from repro_torch.data.synthetic import CTRSpec, DriftingCTR, SyntheticCTR
from repro_torch.device import full_float32, resolve_device
from repro_torch.dist.mesh import (launch_session, parse_mesh_flag,
                                   world_rank)
from repro_torch.embeddings.table import FieldSpec, total_vocab
from repro_torch.models.dlrm import DLRM, DLRMConfig
from repro_torch.serve.engine import Engine
from repro_torch.serve.queue import DONE, FAILED, SHED
from repro_torch.serve.repack import (RepackPlanner, TableSwapper,
                                      headroom_capacities,
                                      subtable_capacities)
from repro_torch.train.optimizer import adam
from repro_torch.zoo import dlrm_builder

DEFAULT_VOCABS = (2000, 1000, 1500, 800)


def train_packed_dlrm(*, field_vocabs=DEFAULT_VOCABS, train_steps: int = 120,
                      train_batch: int = 1024, d_embed: int = 16,
                      mlp_hidden=(64, 32), lam: float = 3e-5, seed: int = 0,
                      device=None):
    """The MPE pipeline in brief → (serve cfg, params, state, buffers, dataset
    spec, pipeline result): the packed table and the retrained interaction
    net are what the engine binds at cell registration. Runs on ``device``
    (the CUDA card unless the caller names another)."""
    device = resolve_device(device)
    full_float32(device)
    spec = CTRSpec(field_vocabs=tuple(field_vocabs), batch_size=train_batch,
                   seed=seed)
    ds = SyntheticCTR(spec)
    fields = tuple(FieldSpec(f"f{i}", v) for i, v in enumerate(spec.field_vocabs))
    base = DLRMConfig(fields=fields, d_embed=d_embed, mlp_hidden=tuple(mlp_hidden),
                      backbone="dnn")
    build = dlrm_builder(base, ds.expected_frequencies(), lam=lam, device=device)
    res = run_mpe_pipeline(build, ds.batch, seed=seed,
                           mpe_cfg=MPEConfig(lam=lam), optimizer=adam(1e-3),
                           search_steps=train_steps, retrain_steps=train_steps,
                           log_fn=lambda *a: None)
    meta = res["packed_meta"]
    cfg = base._replace(compressor="packed",
                        comp_cfg={"bits": meta["bits"], "d": meta["d"],
                                  "n": meta["n"]})
    params = {k: v for k, v in res["final_params"].items() if k != "embedding"}
    params["embedding"] = res["packed_table"]
    buffers = dict(res["buffers"], embedding={"meta": meta})
    return cfg, params, res["state"], buffers, spec, res


def build_engine(cfg, params, state, buffers, *,
                 p99_rows: int = SERVE_ROWS["serve_p99"],
                 bulk_rows: int = SERVE_ROWS["serve_bulk"],
                 lookup_split: bool = True, store=None, device=None,
                 mesh=None, shard_lookup: bool | None = None,
                 lookup_comms: str = "psum",
                 bucket_capacity: int | None = None,
                 queue_capacity: int = 1024, quotas=None,
                 shed_watermark: float = 1.0,
                 coalesce_window_ms: float = 0.0, clock=None) -> Engine:
    """An engine with the standard cell-shape registry for one DLRM table,
    on ``device`` (the CUDA card unless the caller names another).

    With a ``repro_torch.cache.TieredTableStore`` in ``store``, the same
    shapes are also registered as tiered cells (``tiered_p99``/
    ``tiered_bulk``) served through ``engine.score_tiered``. ``mesh`` is
    the engine's (default: the host mesh); ``shard_lookup`` (default: on
    exactly when the mesh has more than one rank) routes the packed and hot
    gathers through the sharded lookups of ``repro_torch.dist.shard``, and
    ``lookup_comms="a2a"`` switches them to the capacity-bucketed
    all-to-all (``bucket_capacity`` ids a bucket, overflow spilling to an
    integer all_reduce — bit-exact at any capacity). ``quotas`` /
    ``shed_watermark`` / ``coalesce_window_ms`` / ``clock`` pass through to
    the engine's multi-tenant admission and scheduling policy."""
    engine = Engine(device=device, mesh=mesh, queue_capacity=queue_capacity,
                    quotas=quotas, shed_watermark=shed_watermark,
                    coalesce_window_ms=coalesce_window_ms, clock=clock)
    if shard_lookup is None:
        shard_lookup = engine.mesh.size > 1
    sharding = {"shard_lookup": shard_lookup, "lookup_comms": lookup_comms,
                "bucket_capacity": bucket_capacity}
    engine.register_packed_model(
        "dlrm", DLRM, cfg, params, state, buffers,
        shapes={"serve_p99": p99_rows, "serve_bulk": bulk_rows},
        lookup_split=lookup_split, **sharding)
    if store is not None:
        engine.register_tiered_model(
            "dlrm", DLRM, cfg, params, state, buffers, store,
            shapes={"tiered_p99": p99_rows, "tiered_bulk": bulk_rows},
            **sharding)
    return engine


def build_packed_dlrm(cfg, *, seed: int = 0, device=None):
    """A packed-table DLRM with random weights from ``seed`` and the Zipf
    frequency prior of ``SyntheticCTR`` over ``cfg``'s fields. Returns
    (params, buffers, state, request-stream spec)."""
    spec = CTRSpec(field_vocabs=tuple(f.vocab for f in cfg.fields), seed=seed)
    freqs = SyntheticCTR(spec).expected_frequencies()
    params, buffers, state = DLRM.init(cfg, freqs, seed=seed, device=device)
    return params, buffers, state, spec


def packed_master(cfg, *, seed: int = 0, device=None) -> dict:
    """The full-precision master behind ``build_packed_dlrm(cfg, seed=seed)``'s
    random table: ``Packed.draw`` from a generator seeded as ``DLRM.init``
    seeds its own, which draws the table first. A ``run_mpe_pipeline``-shaped
    dict holding what ``repack_tools`` reads: ``final_params["embedding"]``
    ({emb, alpha, beta}), ``group_bits``, ``feature_bits_idx`` and
    ``packed_meta``."""
    device = resolve_device(device)
    spec = CTRSpec(field_vocabs=tuple(f.vocab for f in cfg.fields), seed=seed)
    freqs = SyntheticCTR(spec).expected_frequencies()
    gen = torch.Generator(device=device).manual_seed(seed)
    n = total_vocab(cfg.fields)
    params, _, gb, fb = Packed.draw(gen, n, cfg.d_embed, freqs, cfg.comp_cfg)
    return {"final_params": {"embedding": {k: params[k] for k in
                                           ("emb", "alpha", "beta")}},
            "group_bits": gb.cpu().numpy(),
            "feature_bits_idx": fb.cpu().numpy(),
            "packed_meta": {"bits": tuple(cfg.comp_cfg["bits"]),
                            "d": cfg.d_embed, "n": n}}


def repack_tools(engine, res, frequencies, *, lam: float = 3e-5):
    """A ``(RepackPlanner, TableSwapper)`` pair bound to a live engine.

    ``res`` is the ``run_mpe_pipeline`` result dict or ``packed_master``'s
    (the swapper re-packs from its full-precision master embedding);
    ``frequencies`` orders the planner's demote/promote priorities and
    recovers the feature→group map the table was sampled with (serving
    buffers don't carry it). Capacities default to the engine's live
    subtable shapes."""
    mpe_cfg = MPEConfig(bits=tuple(res["packed_meta"]["bits"]), lam=lam)
    gof, _ = make_groups(frequencies, mpe_cfg.group_size)
    planner = RepackPlanner(res["packed_meta"], gof.numpy(),
                            subtable_capacities(engine.live_packed_table()),
                            frequencies=frequencies)
    emb = res["final_params"]["embedding"]
    swapper = TableSwapper(engine, emb["emb"], emb["alpha"], emb["beta"],
                           mpe_cfg)
    return planner, swapper


def run_open_loop(engine, make_ids, n_requests: int, qps: float, *,
                  seed: int = 0, deadline_ms: float | None = None,
                  kind: str = "score", on_submit=None) -> dict:
    """Open-loop replay: offered traffic at ``qps`` on a virtual timeline.

    Arrivals are seeded exponential inter-arrival times (Poisson traffic at
    the offered rate); they **don't wait for service** — when the offered
    rate exceeds capacity the queue grows until the admission policy sheds.
    The scheduler threads the virtual clock through dispatch (queue-wait is
    virtual time from arrival to first dispatch) while assembly/compute are
    measured on the engine's clock. Inject ``serve.TickClock`` into the
    engine to make the whole trajectory deterministic: it then equals the
    reference's, read for read.

    ``on_submit(i, ids)`` (optional) runs right before request ``i`` is
    admitted — the hook the launcher uses to interleave writebacks
    (``Engine.writeback_embeddings``) with live traffic.

    Returns {tickets, makespan_s, offered_qps, goodput_qps, completed,
    shed, failed} — per-request latency percentiles live in
    ``engine.request_summary()``.
    """
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / qps, size=n_requests))
    tickets, shed = [], 0
    now, i = 0.0, 0
    while i < n_requests or engine.scheduler.busy:
        if not engine.scheduler.busy and i < n_requests and arrivals[i] > now:
            now = float(arrivals[i])        # idle server: jump to the arrival
        while i < n_requests and arrivals[i] <= now:
            ids = make_ids(i)
            if on_submit is not None:
                on_submit(i, ids)
            t = engine.submit(ids, kind=kind, now=float(arrivals[i]),
                              deadline_ms=deadline_ms)
            if t is None:
                shed += 1
            tickets.append(t)
            i += 1
        now = engine.sched_step(now=now)
        if (not engine.scheduler._progress and i < n_requests
                and float(arrivals[i]) < now):
            # the round held for its coalescing window and jumped the cursor
            # past the next arrival — cap the jump so that arrival gets to
            # join the held batch before the window decision is remade
            now = float(arrivals[i])
    completed = sum(1 for t in tickets
                    if t is not None and engine._requests[t].status == DONE)
    shed += sum(1 for t in tickets
                if t is not None and engine._requests[t].status == SHED)
    failed = sum(1 for t in tickets
                 if t is not None and engine._requests[t].status == FAILED)
    makespan = max(now, float(arrivals[-1])) if n_requests else now
    return {"tickets": tickets, "makespan_s": makespan,
            "offered_qps": qps,
            "goodput_qps": completed / makespan if makespan > 0 else 0.0,
            "completed": completed, "shed": shed, "failed": failed}


def run_open_loop_mix(engine, make_ids, streams, *, seed: int = 0,
                      kind: str = "score") -> dict:
    """Multi-tenant open-loop replay: merge several Poisson request streams
    onto one virtual timeline.

    Each stream is a dict: ``{"tenant": str, "qps": float, "n_requests":
    int, "priority": int = 0, "deadline_ms": float | None = None,
    "batch": int | None = None}``. Arrivals across streams interleave in
    timestamp order and every request is submitted with its stream's
    tenant/priority/deadline. ``make_ids(i, batch)`` makes the i-th
    request's id batch (``batch=None`` means the stream's default size).

    Returns {makespan_s, per_stream: {tenant: {offered_qps, completed,
    shed, failed, goodput_qps}}}; per-lane/per-tenant percentiles live in
    ``engine.request_summary(by=...)``.
    """
    rng = np.random.default_rng(seed)
    events = []     # (arrival_t, global_idx, stream)
    gi = 0
    for s in streams:
        arr = np.cumsum(rng.exponential(1.0 / s["qps"],
                                        size=s["n_requests"]))
        for t in arr:
            events.append((float(t), gi, s))
            gi += 1
    events.sort(key=lambda e: (e[0], e[1]))
    tickets = {id(s): [] for s in streams}
    submitted_shed = {id(s): 0 for s in streams}
    now, i = 0.0, 0
    while i < len(events) or engine.scheduler.busy:
        if not engine.scheduler.busy and i < len(events) \
                and events[i][0] > now:
            now = events[i][0]
        while i < len(events) and events[i][0] <= now:
            t_arr, idx, s = events[i]
            t = engine.submit(make_ids(idx, s.get("batch")), kind=kind,
                              now=t_arr, deadline_ms=s.get("deadline_ms"),
                              tenant=s.get("tenant", "default"),
                              priority=s.get("priority", 0))
            if t is None:
                submitted_shed[id(s)] += 1
            tickets[id(s)].append(t)
            i += 1
        now = engine.sched_step(now=now)
        if (not engine.scheduler._progress and i < len(events)
                and events[i][0] < now):
            now = events[i][0]
    makespan = max(now, events[-1][0]) if events else now
    per_stream = {}
    for s in streams:
        stats = {DONE: 0, SHED: submitted_shed[id(s)], FAILED: 0}
        for t in tickets[id(s)]:
            if t is None:
                continue
            st = engine._requests[t].status
            if st in stats:
                stats[st] += 1
        per_stream[s.get("tenant", "default")] = {
            "offered_qps": s["qps"], "completed": stats[DONE],
            "shed": stats[SHED], "failed": stats[FAILED],
            "goodput_qps": (stats[DONE] / makespan if makespan > 0 else 0.0)}
    return {"makespan_s": makespan, "per_stream": per_stream}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="dlrm-criteo")
    ap.add_argument("--reduced", action="store_true",
                    help="8 fields of 1,000 ids and a (32, 16) MLP")
    ap.add_argument("--requests", type=int, default=20,
                    help="number of scoring requests to send")
    ap.add_argument("--batch", type=int, default=300,
                    help="rows per scoring request (any size; the batcher "
                         "pads/chunks onto the registered cell shapes)")
    ap.add_argument("--bulk", type=int, default=0,
                    help="also send one bulk job of this many rows")
    ap.add_argument("--p99-rows", type=int, default=SERVE_ROWS["serve_p99"])
    ap.add_argument("--bulk-rows", type=int, default=SERVE_ROWS["serve_bulk"])
    ap.add_argument("--train-steps", type=int, default=0,
                    help="serve what the MPE pipeline trains in this many "
                         "search and retrain steps on the arch's fields "
                         "(0: a random packed table from --seed)")
    ap.add_argument("--qps", type=float, default=None,
                    help="open-loop mode: offer --requests requests of "
                         "--batch rows at this rate with seeded exponential "
                         "inter-arrival times; concurrent requests coalesce "
                         "through the admission queue onto shared cells")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="open-loop per-request deadline: requests still "
                         "queued past it are shed instead of dispatched")
    ap.add_argument("--queue-capacity", type=int, default=1024,
                    help="admission-queue bound (reject-on-full shedding)")
    ap.add_argument("--coalesce-window-ms", type=float, default=0.0,
                    help="max-wait coalescing window: hold a light load up "
                         "to this long for a fuller bucket (0 dispatches "
                         "immediately)")
    ap.add_argument("--repack-budget", type=float, default=None,
                    help="serving-time precision adaptation: halfway through "
                         "the request stream, plan a new per-group "
                         "assignment at this fraction of the current packed "
                         "payload bytes and swap it into the live cells "
                         "(zero recompiles, asserted)")
    ap.add_argument("--repack-headroom", type=float, default=None,
                    help="pack the serving table with every non-zero width "
                         "bucket sized to hold this fraction of the features "
                         "(headroom_capacities)")
    ap.add_argument("--hot-frac", type=float, default=None,
                    help="also serve through a hot/cold TieredTableStore "
                         "pinning this fraction of features on the device "
                         "(repro_torch.cache; requests go through "
                         "score_tiered with cold fills staged one chunk "
                         "ahead)")
    ap.add_argument("--cache-policy", choices=("static", "decay"),
                    default=None,
                    help="tier policy over the TieredTableStore (requires "
                         "--hot-frac; open-loop requests then ride the "
                         "tiered lane): 'decay' adapts the hot set with "
                         "exponential-decay admission scores, 'static' "
                         "keeps the frequency split but runs the same "
                         "observation/plan machinery")
    ap.add_argument("--decay-halflife", type=float, default=256.0,
                    help="decay-policy score half-life, in observation "
                         "ticks (one tick per dispatched chunk)")
    ap.add_argument("--policy-every", type=int, default=8,
                    help="plan/apply tier moves every this many scheduling "
                         "rounds")
    ap.add_argument("--writeback", type=int, default=0,
                    help="every N requests, write the request's features' "
                         "master embeddings back through "
                         "Engine.writeback_embeddings (0 disables)")
    ap.add_argument("--drift", type=float, default=0.0,
                    help="non-stationary traffic: rotate each field's "
                         "popularity ranks by this many ids per request "
                         "step (DriftingCTR)")
    ap.add_argument("--shift-at", type=int, default=None,
                    help="hard popularity shift: from this request step on, "
                         "rotate each field's hot set by --shift-frac of "
                         "its vocabulary")
    ap.add_argument("--shift-frac", type=float, default=0.3,
                    help="fraction of each field's vocabulary the "
                         "--shift-at popularity shift moves")
    ap.add_argument("--mesh", default=None,
                    help="'dp,mp', 'pod,dp,mp' or 'auto': serve on a (data, "
                         "model) — or (pod, data, model) — mesh of ranks "
                         "(repro_torch.dist): requests split over the "
                         "non-model axes, packed subtables row-sharded over "
                         "model. Start the ranks with python -m "
                         "torch.distributed.run --nproc-per-node N")
    ap.add_argument("--lookup-comms", choices=("psum", "a2a"), default="psum",
                    help="model-axis comms of the sharded lookup: 'psum' "
                         "merges the dequantized partials, 'a2a' sends the "
                         "ids to their owners and ships back only the "
                         "packed words (capacity-bucketed; bit-exact "
                         "either way)")
    ap.add_argument("--bucket-capacity", type=int, default=None,
                    help="a2a ids per destination shard per batch slice "
                         "(default: the full slice, no overflow); overflow "
                         "ids spill to an integer all_reduce")
    ap.add_argument("--coordinator", default=None,
                    help="multi-host: coordinator host:port of the process "
                         "group (default: MASTER_ADDR:MASTER_PORT, as "
                         "torch.distributed.run sets them)")
    ap.add_argument("--num-hosts", type=int, default=None,
                    help="multi-host: total process count (default: "
                         "WORLD_SIZE)")
    ap.add_argument("--host-id", type=int, default=None,
                    help="multi-host: this process's index in [0, num-hosts) "
                         "(default: RANK)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the open-loop "
                         "inter-arrival times")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--json", default=None,
                    help="write the latency summary to this path")
    ap.add_argument("--scores", default=None,
                    help="write each closed-loop request's scores (and the "
                         "bulk job's) to this .npz path")
    args = ap.parse_args(argv)
    if args.cache_policy is not None and args.hot_frac is None:
        ap.error("--cache-policy requires --hot-frac (a tiered store)")
    device = resolve_device(args.device)
    with launch_session(args.coordinator, args.num_hosts, args.host_id,
                        device=device):
        return _run(args, device)


def _run(args, device):
    """The run of ``main`` once the process group (if any) is up."""
    mesh = parse_mesh_flag(args.mesh)
    if mesh is not None:
        print(f"[serve] mesh: {mesh.shape} (rank {world_rank()}, "
              f"lookup comms {args.lookup_comms})")

    cfg = get_arch(args.arch).make_config(reduced=args.reduced)
    res = None
    if args.train_steps:
        cfg, params, state, buffers, spec, res = train_packed_dlrm(
            field_vocabs=tuple(f.vocab for f in cfg.fields),
            train_steps=args.train_steps, d_embed=cfg.d_embed,
            mlp_hidden=cfg.mlp_hidden, seed=args.seed, device=device)
    else:
        params, buffers, state, spec = build_packed_dlrm(cfg, seed=args.seed,
                                                         device=device)
    repacking = args.repack_budget is not None \
        or args.repack_headroom is not None
    if (repacking or args.writeback) and res is None:
        res = packed_master(cfg, seed=args.seed, device=device)
    if args.repack_headroom is not None:
        emb = res["final_params"]["embedding"]
        caps = headroom_capacities(res["packed_meta"],
                                   fraction=args.repack_headroom)
        table, meta = build_packed_table(
            emb["emb"], torch.from_numpy(np.asarray(res["feature_bits_idx"])),
            emb["alpha"], emb["beta"], as_mpe_config(cfg.comp_cfg),
            row_capacities=caps)
        params["embedding"] = table
        res = dict(res, packed_table=table, packed_meta=meta)
        print(f"[serve] headroom capacities: {caps}")
    ratio = Packed.storage_ratio(params["embedding"], buffers["embedding"],
                                 cfg.comp_cfg)
    print(f"[serve] {args.arch} on {device}: {cfg.comp_cfg['n']} features, "
          f"packed ratio={ratio:.4f}")
    store = None
    if args.hot_frac is not None:
        freqs = SyntheticCTR(spec).expected_frequencies()
        store = TieredTableStore(params["embedding"],
                                 buffers["embedding"]["meta"], freqs,
                                 args.hot_frac, device=device)
        s = store.storage()
        print(f"[serve] tiered store: hot_frac={args.hot_frac} "
              f"hot={s['hot_bytes']}B (device) cold={s['cold_bytes']}B (host)")
    engine = build_engine(cfg, params, state, buffers,
                          p99_rows=args.p99_rows, bulk_rows=args.bulk_rows,
                          store=store, device=device, mesh=mesh,
                          lookup_comms=args.lookup_comms,
                          bucket_capacity=args.bucket_capacity,
                          queue_capacity=args.queue_capacity,
                          coalesce_window_ms=args.coalesce_window_ms)
    print(f"[serve] registered cells: "
          f"{dict(sorted(engine.registered_shapes.items()))} "
          f"(compiles={engine.compile_count})")
    if args.cache_policy is not None:
        if args.cache_policy == "decay":
            policy = DecayAdmissionPolicy(store.meta["n"],
                                          halflife=args.decay_halflife)
        else:
            policy = StaticTierPolicy()
        engine.attach_tier_policy(policy, every=args.policy_every)
        print(f"[serve] cache policy: {args.cache_policy} "
              f"(halflife={args.decay_halflife}, every={args.policy_every})")
    # request stream at the requested batch size
    if args.drift or args.shift_at is not None:
        req_ds = DriftingCTR(spec._replace(batch_size=args.batch),
                             drift_rate=args.drift, shift_at=args.shift_at,
                             shift_frac=args.shift_frac, step0=10_000)
        print(f"[serve] drifting traffic: rate={args.drift} "
              f"shift_at={args.shift_at} shift_frac={args.shift_frac}")
    else:
        req_ds = SyntheticCTR(spec._replace(batch_size=args.batch))

    on_submit = None
    if args.writeback:
        master = res["final_params"]["embedding"]["emb"].detach().cpu().numpy()
        offs = buffers["offsets"].cpu().numpy().astype(np.int64)

        def on_submit(i, ids):
            if i == 0 or i % args.writeback:
                return
            gids = np.unique(np.asarray(ids, np.int64) + offs[None, :])
            engine.writeback_embeddings(gids, master[gids])
    repack_info = None

    def queue_repack():
        """Plan at the budget and queue the swap — it lands atomically at
        the engine's next ``sched_step`` boundary, mid-stream."""
        nonlocal repack_info
        freqs = SyntheticCTR(spec).expected_frequencies()
        planner, swapper = repack_tools(engine, res, freqs)
        gbits = np.asarray(res["group_bits"])
        plan = planner.plan_budget(
            gbits, int(args.repack_budget * planner.bytes_packed(gbits)))
        swapper.repack(plan)
        repack_info = (engine.compile_count, plan)

    req_kind = "tiered" if args.cache_policy is not None else "score"
    open_loop = None
    scores = {}
    if args.qps:
        warm_ids = req_ds.batch(9_999)["ids"]
        engine.score(warm_ids)                     # the dispatch path warm
        if req_kind == "tiered":
            engine.score_tiered(warm_ids)
        if args.repack_budget is not None:
            queue_repack()   # applies at the open loop's first round
        open_loop = run_open_loop(
            engine, lambda i: req_ds.batch(10_000 + i)["ids"], args.requests,
            args.qps, seed=args.seed, deadline_ms=args.deadline_ms,
            kind=req_kind, on_submit=on_submit)
    else:
        for step in range(args.requests):
            if args.repack_budget is not None and step == args.requests // 2:
                queue_repack()
            ids = req_ds.batch(10_000 + step)["ids"]
            if on_submit is not None:
                on_submit(step, ids)
            scores[f"request_{step}"] = engine.score(ids)
            if store is not None:
                scores[f"tiered_{step}"] = engine.score_tiered(ids)
    if repack_info is not None:
        c0, plan = repack_info
        if engine.compile_count != c0 or engine.swaps_applied != 1:
            raise RuntimeError("the serving-time repack recompiled a cell or "
                               "did not land — the zero-recompile swap is "
                               "broken")
        print(f"[serve] repack: bytes {plan.bytes_before} -> "
              f"{plan.bytes_packed} ({plan.n_features_moved} features "
              f"moved), swaps={engine.swaps_applied}, recompiles=0")
    if args.bulk:
        bulk_ids = SyntheticCTR(spec._replace(batch_size=args.bulk)).batch(
            99_999)["ids"]
        scores["bulk"] = engine.score(bulk_ids)
        if store is not None:
            scores["tiered_bulk"] = engine.score_tiered(bulk_ids)
    skip = min(3, max(args.requests - 1, 0))  # drop the first, cold requests
    print(engine.stats.format_table(skip_warmup=skip))
    if open_loop is not None:
        print(f"[serve] open loop: offered={open_loop['offered_qps']:.1f}qps "
              f"goodput={open_loop['goodput_qps']:.1f}qps "
              f"completed={open_loop['completed']} shed={open_loop['shed']}")
        print(engine.rstats.format_table(skip_warmup=skip))
    counters = engine.counters()
    print(f"[serve] cell cache: compiles={counters['compiles']} "
          f"hits={counters['hits']} replays={engine.cache.replays()}")
    if store is not None:
        c = store.counters()
        print(f"[serve] tiers: hit_rate={c['hit_rate']:.3f} "
              f"cold_bytes_moved={c['bytes_moved']}")
        if args.cache_policy is not None:
            m = engine.tier_moves
            print(f"[serve] tier policy: plans={m['plans']} "
                  f"promotions={m['promotions']} demotions={m['demotions']} "
                  f"moved_bytes={m['bytes']}")
        if args.writeback:
            print(f"[serve] writeback: writes={c['writebacks']} "
                  f"bytes={c['writeback_bytes']}")
    lead = world_rank() == 0      # every rank computed the same
    if args.scores and lead:
        np.savez(args.scores, **scores)
    if args.json and lead:
        with open(args.json, "w") as f:
            json.dump({"device": str(device), "storage_ratio": ratio,
                       "cells": engine.stats.summary(skip_warmup=skip),
                       "requests": engine.request_summary(skip_warmup=skip),
                       "open_loop": ({k: v for k, v in open_loop.items()
                                      if k != "tickets"}
                                     if open_loop is not None else None),
                       "counters": counters,
                       "mesh": None if mesh is None else mesh.shape,
                       "tiers": (store.counters() if store is not None
                                 else None)}, f, indent=2)
    return engine


if __name__ == "__main__":
    main()
