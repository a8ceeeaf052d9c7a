"""The port's static contract checker: every rule fires on a violation
seeded here, each pragma suppresses only its rule, the clean port gives
zero findings, and the parts shared with the reference (``Finding``,
pragmas, fingerprints, signatures) agree with ``repro.analysis`` on the
same inputs.

The seeds are the port's own: an inline int8 -> float32 dequant and an
implicit int8 promotion in a module under a ``repro_torch/`` path (PF102),
a float64 op (PF101), a Python number in ``bound`` (RC301), a sharded
scope on a 1x2 ``LocalMesh`` whose partials are never merged (SC204), and
a budget cut below the measured collective bytes (BC501). Nothing is built
on the reference's own PF101/PF102/SC204 fixtures.
"""
import hashlib
import importlib.util
import os
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import findings as jfindings
from repro.analysis import recompile as jrecompile
from repro.serve import cells as jcells
from repro_torch.analysis.budgets import (HEADROOM, budget_entry,
                                          check_budget, load_budgets,
                                          measure_collectives)
from repro_torch.analysis.findings import (Finding, filter_suppressed,
                                           parse_pragmas)
from repro_torch.analysis.lint import lint_source, lint_tree
from repro_torch.analysis.op_walk import OpWalk
from repro_torch.analysis.precision import check_precision
from repro_torch.analysis.recompile import (check_fingerprint,
                                            check_key_collisions,
                                            check_trace_determinism)
from repro_torch.analysis.shardspec import (check_celldef_specs,
                                            check_scope_merges,
                                            check_spec_tree)
from repro_torch.dist.sharding import P
from repro_torch.dist.shard import LocalMesh, _LocalExchange
from repro_torch.kernels import region
from repro_torch.serve.cells import ServeCellDef

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(findings):
    return [f.code for f in findings]


def _walk(fn, *args):
    with OpWalk() as w:
        fn(*args)
    return w


def _celldef(**kw):
    d = dict(arch="t", shape="s", kind="score", batch=4,
             step_fn=lambda x: x * 2.0, bound=(),
             request_specs=(((4, 3), torch.float32),),
             meta={"kind": "score"}, static=None,
             bound_pspecs=(), request_pspecs=(P(None, None),),
             out_pspecs=P(None, None))
    d.update(kw)
    return ServeCellDef(**d)


def _seeded_module(tmp_path, source: str, name: str):
    """A module written under a ``repro_torch/`` path, so its frames are
    attributable user frames of the port."""
    pkg = tmp_path / "seeded" / "repro_torch"
    pkg.mkdir(parents=True, exist_ok=True)
    path = pkg / f"{name}.py"
    path.write_text(textwrap.dedent(source))
    spec = importlib.util.spec_from_file_location(f"seeded_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- findings and pragmas: the reference's format -----------------------------

FINDINGS = [("PF102", "m", "cell", "/x/mod.py", 7, 3),
            ("SC202", "spec", "src/a.py", "src/a.py", 2, 1),
            ("BC502", "no budget", "dlrm/serve_p99@64", None, None, 1)]


@pytest.mark.parametrize("code,message,where,file,line,col", FINDINGS)
def test_finding_render_equals_the_reference(code, message, where, file, line,
                                             col):
    mine = Finding(code, message, where, file=file, line=line, col=col)
    ref = jfindings.Finding(code, message, where, file=file, line=line,
                            col=col)
    assert mine.render() == ref.render()


def test_parse_pragmas_equals_the_reference():
    src = ("x = 1  # staticcheck: ignore[PF102, SC202]\n"
           "y = 2  # staticcheck: ignore\n"
           "z = 3\n"
           "w = 4  #staticcheck:ignore[RL403]\n")
    assert parse_pragmas(src) == jfindings.parse_pragmas(src)
    assert parse_pragmas(src) == {1: {"PF102", "SC202"}, 2: None,
                                  4: {"RL403"}}


# -- precision flow (PF1xx) -------------------------------------------------

def test_pf101_float64_op(tmp_path):
    mod = _seeded_module(tmp_path, """\
        import torch

        def widen(x):
            return x.to(torch.float64) * 2.0
    """, "wide")
    w = _walk(mod.widen, torch.ones(4))
    found = [f for f in check_precision(w, "seeded") if f.code == "PF101"]
    assert found and found[0].file.endswith("repro_torch/wide.py")
    assert found[0].line == 4


def test_pf102_inline_dequant_attributed_to_its_line(tmp_path):
    mod = _seeded_module(tmp_path, """\
        import torch

        def bad_lookup(table, alpha, ids):
            codes = table[ids]
            return codes.to(torch.float32) * alpha   # inline dequant

        def promoted(table, alpha, ids):
            return table[ids] * alpha                # int8 promoted
    """, "bad_cell")
    table = torch.zeros((16, 8), dtype=torch.int8)
    ids = torch.zeros(4, dtype=torch.long)
    for fn, line in ((mod.bad_lookup, 5), (mod.promoted, 8)):
        w = _walk(fn, table, torch.tensor(0.1), ids)
        pf102 = [f for f in check_precision(w, "seeded", packed=True)
                 if f.code == "PF102"]
        assert pf102 and pf102[0].file.endswith("repro_torch/bad_cell.py")
        assert pf102[0].line == line


def test_pf102_sanctioned_dequant_is_clean():
    """The same widening routed through core.quantizer is attributed to
    the sanctioned module and passes."""
    from repro_torch.core.quantizer import dequantize_codes
    codes = torch.zeros((4, 8), dtype=torch.int8)
    w = _walk(lambda c: dequantize_codes(c, torch.tensor(0.1),
                                         torch.tensor(0.0)), codes)
    assert _codes(check_precision(w, "clean", packed=True)) == []


def test_pf102_int32_only_narrow_in_packed_cells(tmp_path):
    mod = _seeded_module(tmp_path, """\
        import torch

        def index_math(i):
            return i.to(torch.float32)
    """, "index_math")
    w = _walk(mod.index_math, torch.zeros(4, dtype=torch.int32))
    assert _codes(check_precision(w, "x", packed=False)) == []
    assert _codes(check_precision(w, "x", packed=True)) == ["PF102"]
    # a frame outside repro_torch is torch's or the caller's: not ours
    w = _walk(lambda i: i.to(torch.float32),
              torch.zeros(4, dtype=torch.int32))
    assert _codes(check_precision(w, "x", packed=True)) == []


def test_pf103_packed_words_into_float():
    w = _walk(lambda x: x.to(torch.float32),
              torch.zeros(4, dtype=torch.uint32))
    assert _codes(check_precision(w, "seeded")) == ["PF103"]


def test_pf104_int8_arithmetic():
    w = _walk(lambda a, b: a * b, torch.zeros(4, dtype=torch.int8),
              torch.zeros(4, dtype=torch.int8))
    assert _codes(check_precision(w, "seeded")) == ["PF104"]
    w = _walk(lambda a, b: a.to(torch.int32) * b,
              torch.zeros(4, dtype=torch.int8),
              torch.zeros(4, dtype=torch.int32))
    assert _codes(check_precision(w, "seeded")) == []


def test_trace_pragma_suppresses_only_its_rule(tmp_path):
    mod = _seeded_module(tmp_path, """\
        import torch

        def f(codes, x):
            y = codes.to(torch.float32)  # staticcheck: ignore[PF102]
            z = x.to(torch.float64)  # staticcheck: ignore[PF102]
            return y, z
    """, "pragma_cell")
    w = _walk(mod.f, torch.zeros(4, dtype=torch.int8), torch.ones(4))
    found = filter_suppressed(check_precision(w, "seeded"))
    assert _codes(found) == ["PF101"] and found[0].line == 5


# -- kernel regions ------------------------------------------------------------

def test_kernel_call_is_one_opaque_region():
    from repro_torch.kernels.segment_sum import ops as seg_ops
    grad = torch.ones(6, 3)
    ids = torch.tensor([0, 2, 2, 1, 0, 2], dtype=torch.int32)
    w = _walk(lambda g, i: seg_ops.segment_sum(g, i, 4) * 2.0, grad, ids)
    (reg,) = w.regions()
    assert reg.name == "segment_sum" and reg.out_shapes == ((4, 3),)
    assert reg.flops == 6 * 3 and reg.bytes == 6 * 4 + 4 * 6 * 3 + 4 * 4 * 3
    # the plain version's ops are not walked: the region, then the multiply
    assert [it.name for it in w.items] == ["segment_sum", "aten.mul.Tensor"]
    assert region.WALK is None


def test_meta_tensors_take_the_shape_rule_and_charge_the_region():
    from repro_torch.kernels.flash_attention import ops as fops
    q = torch.empty((2, 256, 4, 32), device="meta")
    before = fops.flash_attention_fwd_stats.launches
    with OpWalk() as w:
        o, lse = fops.flash_attention_fwd_stats(q, q, q, True)
    assert o.is_meta and o.shape == q.shape and lse.shape == (2, 4, 256)
    assert fops.flash_attention_fwd_stats.launches == before
    (reg,) = w.regions()
    assert reg.flops == 4 * 2 * 4 * 32 * (256 * 257 // 2)
    # no walk: the same shapes, nothing charged
    o2 = fops.flash_attention_fwd(q, q, q, False)
    assert o2.is_meta and o2.shape == q.shape


# -- sharding contract (SC2xx) -----------------------------------------------

def test_sc201_unknown_axis():
    assert _codes(check_spec_tree(P("rows"), "seeded", role="out")) == \
        ["SC201"]


def test_sc202_out_of_contract_pspec():
    celldef = _celldef(out_pspecs=P(("model", "data"), None))
    assert "SC202" in _codes(check_celldef_specs(celldef))
    assert check_celldef_specs(
        _celldef(out_pspecs=P(("data", "model"), None))) == []


def test_sc202_nested_spec_trees():
    found = check_spec_tree({"k": P(None), "v": P(("model", "pod"))},
                            "seeded", role="bound[0]")
    assert _codes(found) == ["SC202"]


def test_sc204_row_sharded_partial_without_a_merge():
    """The seed: on a 1x2 LocalMesh each shard sums its own rows; without
    the exchange's sum over "model" each rank would return its partial."""
    ex = _LocalExchange(2, ("model",))
    x = torch.ones(4, 8)

    def partial():
        with region.sharded("seeded_partial", ("model",)):
            return [x[2 * s:2 * s + 2].sum(0) for s in ex.shards]

    def merged():
        with region.sharded("seeded_merged", ("model",)):
            return ex.psum([x[2 * s:2 * s + 2].sum(0) for s in ex.shards])

    bad = check_scope_merges(_walk(partial), "seeded")
    assert _codes(bad) == ["SC204"] and "model" in bad[0].message
    assert check_scope_merges(_walk(merged), "clean") == []


@pytest.mark.parametrize("comms", ["psum", "a2a"])
def test_sc204_clean_on_the_sharded_lookup(comms):
    from repro_torch.core.inference import build_packed_table
    from repro_torch.core.mpe import MPEConfig
    from repro_torch.dist.shard import sharded_packed_lookup
    gen = torch.Generator().manual_seed(0)
    n, d = 40, 8
    emb = torch.randn((n, d), generator=gen)
    bits_idx = torch.randint(0, 7, (n,), generator=gen)
    table, meta = build_packed_table(emb, bits_idx, torch.full((7,), 0.1),
                                     torch.zeros(d), MPEConfig())
    ids = torch.randint(0, n, (8, 3), generator=gen, dtype=torch.int32)
    w = _walk(lambda: sharded_packed_lookup(
        table, meta, ids, mesh=LocalMesh(2, 2), lookup_comms=comms,
        bucket_capacity=2))
    assert [s.name for s in w.scopes] == ["sharded_packed_lookup"]
    kinds = {it.name for it in w.collectives()}
    assert ("all-to-all" in kinds) == (comms == "a2a")
    assert check_scope_merges(w, "clean") == []


def _small_packed_table():
    from repro_torch.core.inference import build_packed_table
    from repro_torch.core.mpe import MPEConfig
    gen = torch.Generator().manual_seed(0)
    n, d = 40, 8
    emb = torch.randn((n, d), generator=gen)
    bits_idx = torch.randint(0, 7, (n,), generator=gen)
    table, meta = build_packed_table(emb, bits_idx, torch.full((7,), 0.1),
                                     torch.zeros(d), MPEConfig())
    ids = torch.randint(0, n, (8, 3), generator=gen, dtype=torch.int32)
    return table, meta, ids


@pytest.mark.parametrize("capacity", [None, 2])
def test_sc204_a2a_lookup_declares_its_merges(capacity):
    """The a2a lookup merges by the gather of its slices and, when it
    spills (capacity 2 of 6 ids a slice), by the spill buffer's
    all-reduce: both must run over exactly the row axes."""
    from repro_torch.dist.shard import sharded_packed_lookup
    table, meta, ids = _small_packed_table()
    w = _walk(lambda: sharded_packed_lookup(
        table, meta, ids, mesh=LocalMesh(1, 2), lookup_comms="a2a",
        bucket_capacity=capacity))
    merges = {k for k, _ in w.scopes[0].merges}
    assert merges == ({"all-gather", "all-reduce"} if capacity
                      else {"all-gather"})
    assert check_scope_merges(w, "clean") == []


def test_sc204_a2a_lookup_without_its_spill_all_reduce(monkeypatch):
    """The seed: the a2a lookup's spill buffer left unsummed (each rank
    keeps its own term). Its all-to-alls and its gather still run over
    "model", but they merge no partial: SC204 fires."""
    from repro_torch.dist import shard
    table, meta, ids = _small_packed_table()
    monkeypatch.setattr(shard._LocalExchange, "psum",
                        lambda self, xs: xs[0])
    w = _walk(lambda: shard.sharded_packed_lookup(
        table, meta, ids, mesh=LocalMesh(1, 2), lookup_comms="a2a",
        bucket_capacity=2))
    assert {it.name for it in w.collectives()} == {"all-to-all",
                                                   "all-gather"}
    bad = check_scope_merges(w, "seeded")
    assert _codes(bad) == ["SC204"]
    assert "all-reduce" in bad[0].message and "model" in bad[0].message
    assert bad[0].file.endswith("repro_torch/dist/shard.py")


# -- recompile hazards (RC3xx) -----------------------------------------------

def test_rc301_python_number_in_bound():
    celldef = _celldef(step_fn=lambda s, x: x * s, bound=(3.0,))
    assert celldef.abstract_signature()[0] == ((), "float32", True)
    assert "RC301" in _codes(check_fingerprint(celldef))
    fixed = _celldef(step_fn=lambda s, x: x * s,
                     bound=(torch.tensor(3.0),))
    assert check_fingerprint(fixed) == []


def test_rc302_address_in_fingerprint():
    class Opaque:                               # default __repr__: 0x...
        pass
    assert "RC302" in _codes(check_fingerprint(_celldef(static=Opaque())))


def test_rc303_key_collision_different_signatures():
    a = _celldef()
    b = _celldef(request_specs=(((4, 3), torch.bfloat16),))
    assert a.fingerprint == b.fingerprint
    assert _codes(check_key_collisions([a, b])) == ["RC303"]
    assert check_key_collisions([a, a]) == []


def test_rc304_nondeterministic_walk():
    calls = []

    def step(x):
        calls.append(1)
        return x * float(len(calls))            # constant changes per run

    x = torch.ones(4)
    assert _codes(check_trace_determinism(
        _celldef(), lambda: _walk(step, x))) == ["RC304"]
    assert check_trace_determinism(
        _celldef(), lambda: _walk(lambda y: y * 2.0, x)) == []


BLOBS = ["(score, 64, [('kind', 'score')], None)",
         "(score, 64, [], <object at 0x7f3a2b1c9d40>)",
         "(decode, 4, [('max_len', 8)], LMConfig(n_layers=2))"]


@pytest.mark.parametrize("blob", BLOBS)
def test_rc302_and_rc301_codes_equal_the_reference(blob):
    """The same fingerprint blob and signature give the reference's
    codes."""
    sig = (((4, 3), "int32", False), ((), "float32", True))

    class Stub:
        name = "cell"
        fingerprint_blob = blob

        def abstract_signature(self):
            return sig

    assert _codes(check_fingerprint(Stub())) == \
        _codes(jrecompile.check_fingerprint(Stub()))


def test_rc303_codes_equal_the_reference():
    class Stub:
        def __init__(self, sig, shape="s"):
            self.arch, self.shape, self.batch = "a", shape, 4
            self.fingerprint, self.name, self._sig = "f00", "a/s", sig

        def abstract_signature(self):
            return self._sig

    one = (((4, 3), "int32", False),)
    two = (((4, 3), "bfloat16", False),)
    for cells in ([Stub(one), Stub(two)], [Stub(one), Stub(one)],
                  [Stub(one), Stub(two, shape="t")]):
        assert _codes(check_key_collisions(cells)) == \
            _codes(jrecompile.check_key_collisions(cells))


# -- collective budgets (BC5xx) ---------------------------------------------

def test_bc501_budget_below_the_measured_bytes():
    ex = _LocalExchange(2, ("model",))
    w = _walk(lambda: ex.psum([torch.ones(64), torch.ones(64)]))
    measured = measure_collectives(w)
    assert measured["total_bytes"] == 256
    assert measured["all-reduce"]["count"] == 1
    found = check_budget("cell", measured, {"cell": {"total_bytes": 255}})
    assert _codes(found) == ["BC501"]
    assert check_budget("cell", measured,
                        {"cell": {"total_bytes": 256}}) == []


def test_bc502_missing_budget_entry():
    assert _codes(check_budget("new", {"total_bytes": 0.0}, {})) == ["BC502"]


def test_budget_entry_headroom():
    assert budget_entry({"total_bytes": 1000})["total_bytes"] == \
        int(1000 * HEADROOM)


# -- source lint (RL4xx) ----------------------------------------------------

def test_rl401_hand_rolled_pspec():
    src = ("from repro_torch.dist.sharding import P\n"
           "x = P('data', None)\n"
           "y = maybe_shard(z, P('model', None))\n"
           "w = P(dp, None)\n")
    found = lint_source(src, "src/repro_torch/serve/foo.py")
    assert _codes(found) == ["RL401"] and found[0].line == 2
    assert lint_source(src, "src/repro_torch/dist/sharding.py") == []


@pytest.mark.parametrize("src", [
    "import torch.distributed as dist\ndist.all_reduce(x)\n",
    "import torch\ntorch.distributed.all_to_all_single(o, x)\n",
    "from torch import distributed as d\nd.all_gather_into_tensor(o, x)\n",
    "from torch.distributed import reduce_scatter_tensor\n"
    "reduce_scatter_tensor(o, x)\n",
    "import torch.distributed as dist\ndist.broadcast(x, 0)\n",
])
def test_rl402_raw_collective_outside_dist(src):
    assert _codes(lint_source(src, "src/repro_torch/serve/foo.py")) == \
        ["RL402"]
    assert lint_source(src, "src/repro_torch/dist/shard.py") == []


def test_rl402_leaves_other_calls_alone():
    src = ("import torch.distributed as dist\nn = dist.get_world_size()\n"
           "x.all_reduce()\n")
    assert lint_source(src, "src/repro_torch/serve/foo.py") == []


def test_rl403_host_sync_in_serve():
    src = ("import torch\na = x.item()\nb = x.cpu()\nc = x.tolist()\n"
           "torch.cuda.synchronize()\nd = x.to('cpu', non_blocking=True)\n")
    found = lint_source(src, "src/repro_torch/serve/foo.py")
    assert _codes(found) == ["RL403"] * 4
    assert [f.line for f in found] == [2, 3, 4, 5]
    assert lint_source(src, "src/repro_torch/launch/foo.py") == []


def test_rl404_float64_literal():
    src = ("import torch\nimport numpy as np\n"
           "a = torch.zeros((3,), dtype=torch.float64)\n"
           "b = np.zeros((3,), np.float64)\n"      # host-side: legal
           "c = x.to(torch.double)\n")
    found = lint_source(src, "src/repro_torch/core/foo.py")
    assert _codes(found) == ["RL404", "RL404"]
    assert [f.line for f in found] == [3, 5]


def test_rl405_nondeterminism_in_cell_modules():
    src = "import time\nt = time.time()\nz = torch.randn(3)\n"
    assert _codes(lint_source(src, "src/repro_torch/serve/cells.py")) == \
        ["RL405", "RL405"]
    assert _codes(lint_source(src, "src/repro_torch/launch/cells.py")) == \
        ["RL405", "RL405"]
    assert lint_source(src, "src/repro_torch/serve/engine.py") == []


def test_lint_pragma_suppresses_only_its_rule():
    src = ("import torch\n"
           "x.cpu()  # staticcheck: ignore[RL403]\n"
           "y.item()  # staticcheck: ignore[RL401]\n"
           "z = torch.float64  # staticcheck: ignore[RL403]\n")
    found = lint_source(src, "src/repro_torch/serve/foo.py")
    assert [(f.code, f.line) for f in found] == [("RL403", 3),
                                                 ("RL404", 4)]


def test_lint_clean_on_the_port():
    assert [f.render() for f in lint_tree(REPO_ROOT)] == []


# -- the clean port: the corpus on the CPU ----------------------------------

@pytest.fixture(scope="module")
def corpus_engine():
    from repro_torch.analysis.corpus import build_corpus
    return build_corpus(device="cpu")


def test_registered_cells(corpus_engine):
    names = {reg.celldef.name
             for reg in corpus_engine.registered_cells().values()}
    assert names == {"dlrm/serve_p99", "dlrm/serve_p99.lookup",
                     "dlrm/serve_bulk", "dlrm/serve_bulk.lookup",
                     "dlrm/tiered_p99", "dlrm/tiered_bulk",
                     "lm-tiny/decode", "lm-cb/decode_cb"}


def test_clean_corpus_no_findings(corpus_engine):
    from repro_torch.analysis.runner import check_engine
    budgets = load_budgets()
    rep = check_engine(corpus_engine, budgets=budgets)
    assert rep.n_cells == 8
    assert [f.render() for f in rep.findings] == []
    # one rank: no collective; the a2a cells only register on a mesh
    assert all(m["total_bytes"] == 0 for m in rep.measured.values())
    assert set(budgets) - set(rep.measured) == {"dlrm/serve_p99_a2a@64",
                                                "dlrm/tiered_p99_a2a@64"}
    assert rep.regions["dlrm/tiered_p99"] == ["mpe_lookup", "tiered_cold"]
    assert rep.regions["lm-tiny/decode"] == ["decode_attention",
                                             "kv_cache_write"]
    # three walks a cell (one, and RC304's two) for each cell showing it
    assert rep.region_walks == {
        name: 3 * sum(name in names for names in rep.regions.values())
        for names in rep.regions.values() for name in names}


def test_fingerprints_and_keys_ignore_the_spec_fields(corpus_engine):
    """The spec fields enter neither the fingerprint (the parent's formula,
    recomputed here) nor the ``CellKey``."""
    for reg in corpus_engine.registered_cells().values():
        cd = reg.celldef
        blob = repr((cd.kind, cd.batch, sorted(cd.meta.items(), key=str),
                     cd.static))
        assert cd.fingerprint == hashlib.sha1(blob.encode()).hexdigest()[:12]
        bare = cd._replace(bound_pspecs=(), request_pspecs=(),
                           out_pspecs=None)
        assert bare.fingerprint == cd.fingerprint
        key = corpus_engine.cache.key(
            cd.arch, f"{cd.shape}@{cd.batch}#{bare.fingerprint}",
            bound=cd.bound)
        assert key == reg.cell.key


def _spec_leaves(tree) -> list:
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _spec_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]


def test_declared_specs_match_the_trees(corpus_engine):
    """One spec a leaf, of rank at most the leaf's (the reference's
    tests/test_cells.py structure check, on the serving cells)."""
    from repro_torch.train.tree import leaves
    for reg in corpus_engine.registered_cells().values():
        cd = reg.celldef
        assert len(cd.bound_pspecs) == len(cd.bound)
        assert len(cd.request_pspecs) == len(cd.request_specs)
        for tree, specs in zip(cd.bound, cd.bound_pspecs):
            got = _spec_leaves(specs)
            assert len(leaves(tree)) == len(got), cd.name
            for x, ps in zip(leaves(tree), got):
                assert isinstance(ps, P)
                assert len(ps) <= max(getattr(x, "ndim", 0), 1), cd.name


def _to_jax(tree):
    """The port's tensors as the reference holds them (packed words as
    uint32)."""
    if isinstance(tree, dict):
        return {k: (_to_jax(v) if k != "subtables" else
                    {b: jnp.asarray(w.numpy().view(np.uint32))
                     for b, w in v.items()}) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_jax(v) for v in tree)
    return jnp.asarray(tree.numpy()) if torch.is_tensor(tree) else tree


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk"])
def test_dlrm_signatures_equal_the_reference(corpus_engine, shape):
    """The request part equals the reference's leaf for leaf. The bound
    part holds the same leaves counted by (shape, dtype), with one stated
    departure: the port holds packed words as int32 (torch and gloo have
    no uint32 arithmetic), the reference as uint32."""
    cells = {reg.celldef.name: reg.celldef
             for reg in corpus_engine.registered_cells().values()}
    score, lookup = cells[f"dlrm/{shape}"], cells[f"dlrm/{shape}.lookup"]
    params, state, buffers = (_to_jax(t) for t in score.bound)
    j_score = jcells.packed_score_cell(
        None, score.static, params, state, buffers, batch=score.batch,
        arch="dlrm", shape=shape)
    table, offsets = (_to_jax(t) for t in lookup.bound)
    j_lookup = jcells.packed_lookup_cell(
        table, dict(zip(("bits", "d", "n"), lookup.static)), offsets,
        batch=lookup.batch, n_fields=lookup.meta["n_fields"], arch="dlrm",
        shape=shape)
    for mine, ref in ((score, j_score), (lookup, j_lookup)):
        n_req = len(mine.request_specs)
        got, want = mine.abstract_signature(), ref.abstract_signature()
        assert got[-n_req:] == want[-n_req:]
        as_int32 = sorted((s, "int32" if d == "uint32" else d, w)
                          for s, d, w in want[:-n_req])
        assert sorted(got[:-n_req]) == as_int32
        assert any(d == "uint32" for _, d, _ in want[:-n_req])
        assert not any(w for _, _, w in got)


# -- the gate's command line --------------------------------------------------

def _gate(*args):
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "scripts",
                                      "staticcheck_torch.py"), *args],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO_ROOT)


def test_gate_exits_clean_on_the_cpu():
    proc = _gate("--device", "cpu")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("0 finding(s) across 8 cell(s)")


def test_gate_on_four_gloo_ranks_walks_the_mesh_cells():
    """The corpus on a 2x2 mesh of gloo ranks: the sharded wrappers'
    collectives merge their row axes (SC204) within the checked-in budgets
    (BC501), the a2a cells included."""
    proc = _gate("--world", "4", "--trace-only")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("0 finding(s) across 10 cell(s)")
