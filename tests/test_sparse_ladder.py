"""The sparse probe layouts (XlaLookup probe_impl rows1, chunked, rows,
flat) vs the parity oracle under Zipf-skewed query streams and long probe
chains."""
import numpy as np
import pytest

from kmergutsjava_tpu.constants import MAX_ENCODED
from kmergutsjava_tpu.formats.kmer_table import build_table
from kmergutsjava_tpu.lookup.parity import lookup_stream
from kmergutsjava_tpu.lookup.xla import XlaLookup
from test_lookup import canon
from test_table import random_signatures


def zipf_case(rng, load):
    """Skewed traffic: a few hot k-mers repeat thousands of times (real
    read sets repeat k-mers by coverage), plus a uniform miss tail."""
    sig = random_signatures(rng, 20000)
    table = build_table(**sig, load_factor=load)
    ranks = np.minimum(rng.zipf(1.3, 12000), len(sig["kmers"])) - 1
    hot = sig["kmers"][ranks]
    miss = rng.integers(0, MAX_ENCODED, 4000, dtype=np.int64)
    return table, np.concatenate([hot, miss])


def chain_case(rng, load):
    """Long probe chains: groups of signatures sharing a home slot, so
    windows run far past the first-pass width and into the exact pass."""
    n = 6000
    base = random_signatures(rng, n)
    s = int((n + 20 * 24) / load) | 1
    homes = rng.choice(np.arange(0, s - 400, 400), 20, replace=False)
    chained = (homes[:, None] + s * np.arange(1, 25)).ravel()
    kmers = np.unique(np.concatenate([base["kmers"], chained]))
    # keep the last slots free, so the builder keeps num_sigs = s (a chain
    # reaching the final slot would make it re-roll every home)
    kmers = kmers[kmers % s < s - 256]
    m = len(kmers)
    sig = dict(kmers=kmers,
               otu=rng.integers(0, 50, m).astype(np.int32),
               avg_from_end=rng.integers(0, 500, m).astype(np.int32),
               fi=rng.integers(0, 30, m).astype(np.int32),
               wt=rng.random(m).astype(np.float32))
    table = build_table(**sig, num_sigs=s)
    assert table.max_probe >= 24
    q = np.concatenate([rng.choice(kmers, 6000),
                        (homes[:, None] + s * np.arange(25, 29)).ravel(),
                        rng.integers(0, MAX_ENCODED, 2000, dtype=np.int64)])
    return table, q


@pytest.mark.parametrize("load", [0.5, 0.75])
@pytest.mark.parametrize("case", [zipf_case, chain_case])
@pytest.mark.parametrize("impl", ["rows1", "chunked", "rows", "flat"])
def test_sparse_impl_vs_parity(impl, case, load, monkeypatch):
    rng = np.random.default_rng(
        [len(impl), len(case.__name__), int(load * 100)])
    table, values = case(rng, load)
    rng.shuffle(values)
    cnt = rng.integers(0, 5, len(values)).astype(np.int64)
    pos = np.arange(len(values), dtype=np.int64)
    if impl == "chunked":
        monkeypatch.setenv("KMER_CHUNK_ROWS", "16")  # several chunks
    lk = XlaLookup(table, probe_impl=impl, chunk=4096)
    assert lk.probe_impl == impl
    a = lookup_stream(table, values, cnt, pos)
    b = lk.lookup(values, cnt, pos)
    assert canon(a) == canon(b)
    assert a.kmers_found == b.kmers_found
