"""``launch.trace_analysis``: per-device FLOPs, bytes and collective bytes
of an op walk, held against the reference's HLO analysis on the same
computation, and against hand counts.
"""
import jax
import numpy as np
import pytest
import torch

from repro.launch.hlo_analysis import analyze as hlo_analyze
from repro_torch.analysis.op_walk import OpWalk
from repro_torch.dist.shard import LocalMesh, _LocalExchange
from repro_torch.launch.trace_analysis import analyze, op_flops


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walk(fn, *args):
    with OpWalk() as w:
        fn(*args)
    return w


@pytest.mark.parametrize("n,m,k", [(4, 8, 16), (7, 3, 5), (1, 32, 32)])
def test_flops_of_a_loop_of_products_equal_the_hlo_analysis(n, m, k):
    """N products of (m, k) by (k, k) in a Python loop, walked, against the
    same products as a jitted ``lax.scan`` whose HLO the reference
    analyses with its trip-count weighting."""
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((m, k)).astype(np.float32)
    ws = rng.standard_normal((n, k, k)).astype(np.float32)

    def scan(x, w):
        return jax.lax.scan(lambda c, wi: (c @ wi, None), x, w)[0]

    hlo = jax.jit(scan).lower(x0, ws).compile().as_text()
    want = hlo_analyze(hlo)["flops_per_device"]

    def loop(x, w):
        for i in range(n):
            x = x @ w[i]
        return x

    got = analyze(_walk(loop, torch.from_numpy(x0), torch.from_numpy(ws)))
    assert got["flops_per_device"] == want == 2.0 * n * m * k * k


def test_flops_of_addmm_bmm_and_a_convolution():
    x, w, b = torch.ones(5, 6), torch.ones(7, 6), torch.ones(7)
    wk = _walk(lambda: torch.nn.functional.linear(x, w, b))
    assert analyze(wk)["flops_per_device"] == 2 * 5 * 7 * 6
    a, c = torch.ones(3, 4, 5), torch.ones(3, 5, 2)
    assert analyze(_walk(torch.bmm, a, c))["flops_per_device"] == \
        2 * 3 * 4 * 2 * 5
    img, ker = torch.ones(1, 2, 8, 8), torch.ones(4, 2, 3, 3)
    wk = _walk(lambda: torch.nn.functional.conv2d(img, ker))
    conv = [it for it in wk.items if op_flops(it)]
    assert len(conv) == 1
    assert analyze(wk)["flops_per_device"] == 2 * (4 * 6 * 6) * (2 * 3 * 3)


def test_bytes_count_operands_and_outputs_of_each_op():
    x, y = torch.ones(10), torch.ones(10)
    got = analyze(_walk(lambda: (x + y) * 2.0))
    # add reads 2·40 and writes 40; mul reads 40 and writes 40
    assert got["hbm_bytes_per_device"] == 3 * 40 + 2 * 40
    # views and allocations move nothing
    got = analyze(_walk(lambda: (x.view(2, 5).t(), torch.empty(100))))
    assert got["hbm_bytes_per_device"] == 0


def test_kernel_regions_charge_their_analytic_cost():
    from repro_torch.kernels.segment_sum import ops as seg_ops
    grad = torch.ones(6, 3)
    ids = torch.zeros(6, dtype=torch.int32)
    got = analyze(_walk(lambda: seg_ops.segment_sum(grad, ids, 4)))
    cost = seg_ops.cost(grad, ids, 4)
    assert got["n_regions"] == 1 and got["n_ops"] == 0
    assert got["flops_per_device"] == cost["flops"] == 18
    assert got["hbm_bytes_per_device"] == cost["bytes"]


def test_collectives_per_kind():
    ex = _LocalExchange(2, ("model",))
    got = analyze(_walk(lambda: (ex.psum([torch.ones(8), torch.ones(8)]),
                                 ex.all_gather([torch.ones(3),
                                                torch.ones(3)]),
                                 ex.all_to_all([torch.ones(2, 4)] * 2))))
    coll = got["collectives_per_device"]
    assert coll["all-reduce"] == {"bytes": 32.0, "count": 1}
    assert coll["all-gather"] == {"bytes": 24.0, "count": 1}
    assert coll["all-to-all"] == {"bytes": 32.0, "count": 1}
    assert coll["total_bytes"] == 88.0
    # one shard: no collective at all
    one = _LocalExchange(1, ())
    got = analyze(_walk(lambda: one.psum([torch.ones(8)])))
    assert got["collectives_per_device"] == {"total_bytes": 0.0}


def test_sharded_lookup_collectives_on_a_local_mesh():
    """The psum lookup on a 2x2 LocalMesh: one all_reduce of each data
    slice's (n/2, d) rows over "model", then the all_gather over "data"."""
    from repro_torch.core.inference import build_packed_table
    from repro_torch.core.mpe import MPEConfig
    from repro_torch.dist.shard import sharded_packed_lookup
    gen = torch.Generator().manual_seed(0)
    n, d = 40, 8
    table, meta = build_packed_table(
        torch.randn((n, d), generator=gen),
        torch.randint(1, 7, (n,), generator=gen), torch.full((7,), 0.1),
        torch.zeros(d), MPEConfig())
    ids = torch.randint(0, n, (8, 3), generator=gen, dtype=torch.int32)
    got = analyze(_walk(lambda: sharded_packed_lookup(
        table, meta, ids, mesh=LocalMesh(2, 2))))
    coll = got["collectives_per_device"]
    slice_bytes = 12 * d * 4
    assert coll["all-reduce"] == {"bytes": float(2 * slice_bytes),
                                  "count": 2}
    assert coll["all-gather"] == {"bytes": float(2 * slice_bytes),
                                  "count": 1}
