"""The port's Criteo TSV loader against the reference's, on mini files in the
Criteo format that the tests write (nothing is downloaded): vocabularies,
counts, frequencies and every batch equal the reference's exactly; batches
come out as int32 tensors on the caller's device."""
import numpy as np
import pytest
import torch

from repro.data import criteo as jcriteo
from repro_torch.data import criteo


def write_fixture(path, rows=60, seed=0, *, cat_vocab=8, short_rows=False):
    """``rows`` lines of label, 13 integers and 26 hex categories, some
    missing; with ``short_rows`` every seventh line stops early."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for r in range(rows):
            label = rng.integers(0, 2)
            ints = [("" if rng.random() < 0.2 else str(rng.integers(0, 5000)))
                    for _ in range(13)]
            cats = [("" if rng.random() < 0.1 else
                     f"{rng.integers(0, cat_vocab):08x}") for _ in range(26)]
            parts = [str(label), *ints, *cats]
            if short_rows and r % 7 == 3:
                parts = parts[:20]
            f.write("\t".join(parts) + "\n")


@pytest.mark.parametrize("min_count", [1, 2, 5])
@pytest.mark.parametrize("short_rows", [False, True])
def test_vocabularies_and_frequencies_equal_the_reference(tmp_path, min_count,
                                                          short_rows):
    path = str(tmp_path / "mini.txt")
    write_fixture(path, rows=80, seed=min_count, short_rows=short_rows)
    vocabs, counts = criteo.build_criteo_vocab(path, min_count=min_count)
    want_vocabs, want_counts = jcriteo.build_criteo_vocab(path,
                                                          min_count=min_count)
    assert vocabs == want_vocabs
    assert [dict(c) for c in counts] == [dict(c) for c in want_counts]
    assert criteo.vocab_sizes(vocabs) == jcriteo.vocab_sizes(want_vocabs)
    freqs = criteo.frequencies_from_counts(vocabs, counts)
    want = jcriteo.frequencies_from_counts(want_vocabs, want_counts)
    assert freqs.dtype == want.dtype
    np.testing.assert_array_equal(freqs, want)
    assert (criteo.N_INT, criteo.N_CAT, criteo.N_FIELDS) == \
        (jcriteo.N_INT, jcriteo.N_CAT, jcriteo.N_FIELDS)


def test_max_rows_cuts_the_counting_pass(tmp_path):
    path = str(tmp_path / "mini.txt")
    write_fixture(path, rows=50)
    got = criteo.build_criteo_vocab(path, min_count=1, max_rows=17)
    want = jcriteo.build_criteo_vocab(path, min_count=1, max_rows=17)
    assert got[0] == want[0]


@pytest.mark.parametrize("batch_size", [16, 60, 7, 100])
def test_batches_equal_the_reference(tmp_path, batch_size):
    """Full batches and the last partial one, padded by repetition, equal
    the reference's as int32 tensors on the CPU."""
    path = str(tmp_path / "mini.txt")
    write_fixture(path, rows=60, seed=3, cat_vocab=20)
    vocabs, _ = jcriteo.build_criteo_vocab(path, min_count=2)
    got = list(criteo.CriteoTSV(path, vocabs, batch_size=batch_size,
                                device="cpu"))
    want = list(jcriteo.CriteoTSV(path, vocabs, batch_size=batch_size))
    assert len(got) == len(want) == -(-60 // batch_size)
    for g, w in zip(got, want):
        assert set(g) == {"ids", "label"}
        for k in g:
            assert g[k].device.type == "cpu" and g[k].dtype == torch.int32
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_loop_restarts_the_file(tmp_path):
    path = str(tmp_path / "mini.txt")
    write_fixture(path, rows=20, seed=4)
    vocabs, _ = criteo.build_criteo_vocab(path)
    it = iter(criteo.CriteoTSV(path, vocabs, batch_size=8, loop=True,
                               device="cpu"))
    first = [next(it) for _ in range(3)]
    again = [next(it) for _ in range(3)]
    for a, b in zip(first, again):
        assert torch.equal(a["ids"], b["ids"])
        assert torch.equal(a["label"], b["label"])


def test_rare_tokens_hit_oov(tmp_path):
    path = str(tmp_path / "mini.txt")
    with open(path, "w") as f:
        f.write("\t".join(["1"] + ["7"] * 13 + [f"{i:08x}" for i in
                                                range(100, 126)]) + "\n")
        f.write("\t".join(["0"] + ["7"] * 13 + [f"{i:08x}" for i in
                                                range(200, 226)]) + "\n")
    vocabs, _ = criteo.build_criteo_vocab(path, min_count=2)
    b = next(iter(criteo.CriteoTSV(path, vocabs, batch_size=2, device="cpu")))
    assert (b["ids"][:, 13:] == 0).all()
    assert (b["ids"][:, :13] > 0).all()


def test_the_discretisation_is_the_papers():
    for raw in ("", "0", "1", "2", "3", "7", "100", "4999", "123456"):
        assert criteo._discretize(raw) == jcriteo._discretize(raw)
