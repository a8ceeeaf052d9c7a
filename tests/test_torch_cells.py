"""The port's dry-run cells against the reference's, and the dry run.

For every (arch × shape) the reference's ``repro.launch.cells.build_cell``
builds, the port's meta-tensor stand-ins hold the reference's
``input_specs`` leaf for leaf in shape and dtype (counted over each tree:
the two packages order dict keys differently), each with the same
partition spec. The reference's own structural check
(``tests/test_cells.py``) runs on the port's cells, and one cell's dry
run is held against a hand count from its config.

Two stated departures: the port holds packed words as int32 (the
reference uint32), and the port's Adam keeps float32 moments for a
bfloat16 leaf from init (the reference's type for them after its first
update; at init it holds them in bfloat16).
"""
from collections import Counter

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ALL_ARCHS as J_ALL_ARCHS
from repro.configs import get_arch as j_get_arch
from repro.launch.cells import build_cell as j_build_cell
from repro_torch.configs.base import ALL_ARCHS
from repro_torch.dist.sharding import P, normalize_entry
from repro_torch.launch.cells import build_cell, cell_shapes

CELLS = [(a, s) for a in J_ALL_ARCHS() for s in j_get_arch(a).shapes]
AXIS = {"pod": 2, "data": 16, "model": 16}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec_tuple(spec) -> tuple:
    return tuple(normalize_entry(e) for e in tuple(spec))


def _port_pairs(tree, specs) -> list:
    """(shape, dtype, spec) of each leaf of a port tree with its spec."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _port_pairs(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(specs, P):
        return [x for t, s in zip(tree, specs) for x in _port_pairs(t, s)]
    assert isinstance(specs, P), (tree, specs)
    return [(tuple(tree.shape), str(tree.dtype).replace("torch.", ""),
             _spec_tuple(specs))]


def _ref_pairs(tree, specs) -> list:
    leaves = jax.tree.leaves(tree)
    ps = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(ps)
    moments = isinstance(tree, dict) and "mu" in tree
    as_port = {"uint32": "int32"}
    if moments:
        as_port["bfloat16"] = "float32"
    return [(tuple(x.shape), as_port.get(str(x.dtype), str(x.dtype)),
             _spec_tuple(p)) for x, p in zip(leaves, ps)]


def test_the_port_lists_the_reference_archs():
    assert ALL_ARCHS() == J_ALL_ARCHS()
    for arch in ALL_ARCHS():
        assert set(j_get_arch(arch).shapes) <= set(cell_shapes(arch))


@pytest.mark.parametrize("arch_id,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_stand_ins_and_specs_equal_the_reference(arch_id, shape):
    ref = j_build_cell(arch_id, shape, multi_pod=False)
    cell = build_cell(arch_id, shape, multi_pod=False)
    assert cell.name == ref.name
    assert len(cell.input_specs) == len(ref.input_specs)
    for i, (mine, want, mps, wps) in enumerate(zip(
            cell.input_specs, ref.input_specs, cell.in_pspecs,
            ref.in_pspecs)):
        got = _port_pairs(mine, mps)
        assert Counter(got) == Counter(_ref_pairs(want, wps)), \
            f"{cell.name} input {i}"
        assert all(torch.is_tensor(x) and x.is_meta
                   for x in jax.tree.leaves(mine)
                   if not isinstance(x, (int, float)))


@pytest.mark.parametrize("arch_id,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_structure(arch_id, shape):
    """The reference's tests/test_cells.py check, on the port's cells."""
    cell = build_cell(arch_id, shape, multi_pod=False)
    assert len(cell.input_specs) == len(cell.in_pspecs)
    for tree, ps_tree in zip(cell.input_specs, cell.in_pspecs):
        for shape_, _, ps in _port_pairs(tree, ps_tree):
            assert len(ps) <= max(len(shape_), 1), (cell.name, shape_, ps)
            for dim, axes in zip(shape_, ps):
                if axes is None:
                    continue
                size = 1
                for ax in axes:
                    size *= AXIS[ax]
                assert dim % size == 0 or dim >= size, (cell.name, dim, axes)


def test_multi_pod_cells_use_the_pod_axis():
    cell = build_cell("dlrm-criteo", "train_batch", multi_pod=True)
    ref = j_build_cell("dlrm-criteo", "train_batch", multi_pod=True)
    for mine, want, mps, wps in zip(cell.input_specs, ref.input_specs,
                                    cell.in_pspecs, ref.in_pspecs):
        assert Counter(_port_pairs(mine, mps)) == \
            Counter(_ref_pairs(want, wps))


# -- the dry run ----------------------------------------------------------------

def test_dry_run_flops_equal_a_hand_count():
    """dlrm-criteo/serve_p99 on the 16x16 mesh: the DLRM MLP on 512 rows
    (39 fields of d=16: 624 -> 1024 -> 512 -> 256 -> 1) plus the lookup
    kernel's dequant (a multiply-add an element of each id's row); the
    psum merge of the (512, 39, 16) float32 rows over every axis."""
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.dryrun import run_cell
    cfg = get_arch("dlrm-criteo").make_config(False)
    rows, f, d = 512, len(cfg.fields), cfg.d_embed
    dims = (f * d, *cfg.mlp_hidden, 1)
    mlp = sum(2 * rows * a * b for a, b in zip(dims, dims[1:]))
    lookup = 2 * rows * f * d
    res = run_cell("dlrm-criteo", "serve_p99", verbose=False)
    assert res["flops_per_device"] == mlp + lookup
    assert res["kernel_flops_per_device"] == lookup
    assert res["kernels"] == ["mpe_lookup"]
    coll = res["collectives_per_device"]
    assert coll["total_bytes"] == coll["all-reduce"]["bytes"] == \
        rows * f * d * 4
    assert res["memory"]["output_bytes"] == rows * 4
    assert res["mesh"] == "16x16" and res["n_chips"] == 256


def test_dry_run_train_cell_merges_its_shards():
    """A train cell's rank: the MPE table row-sharded over every axis, the
    batch data-parallel; its walk holds the mpe_qat, segment-sum and Adam
    regions, its collectives run over every axis (SC204 clean), and its
    arguments are the rank's row blocks, not the whole table."""
    from repro_torch.analysis.op_walk import OpWalk
    from repro_torch.analysis.shardspec import check_scope_merges
    from repro_torch.dist.mesh import use_mesh
    from repro_torch.launch.dryrun import _bytes
    from repro_torch.launch.mesh import production_dry_mesh
    cell = build_cell("dlrm-criteo", "train_batch")
    local = cell.localize(cell.input_specs)
    whole = cell.input_specs[0]["embedding"]["emb"]
    assert local[0]["embedding"]["emb"].shape == (whole.shape[0] // 256, 16)
    assert _bytes(local) < _bytes(cell.input_specs)
    with use_mesh(production_dry_mesh()), torch.no_grad(), OpWalk() as w:
        out = cell.step_fn(*local)
    assert out[3].is_meta and out[3].shape == ()
    assert {it.name for it in w.regions()} >= {
        "mixed_expectation_fwd", "mixed_expectation_bwd", "segment_sum",
        "adam_step_"}
    assert check_scope_merges(w, cell.name) == []
    assert {a for it in w.collectives() for a in it.axes} == {"data",
                                                              "model"}


def test_dry_run_cli_writes_the_reference_keys(tmp_path):
    import json
    from repro_torch.launch.dryrun import main
    assert main(["--arch", "internlm2-1.8b", "--shape", "decode_32k",
                 "--out", str(tmp_path), "--tag", "t"]) == 0
    (path,) = tmp_path.glob("dryrun_*.json")
    res = json.loads(path.read_text())
    assert {"flops_per_device", "hbm_bytes_per_device",
            "collectives_per_device", "memory", "meta"} <= set(res)
    assert set(res["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes"}
    assert res["kernels"] == ["decode_attention", "kv_cache_write"]
    assert res["flops_per_device"] > 0 and res["variant"] == "t"
