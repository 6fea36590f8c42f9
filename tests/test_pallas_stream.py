"""StreamLookup (the dense stream probe) vs the parity oracle.

Covers the dense-tile scatter (home collisions beyond C channels fall back
to the exact path), byte-packed result decoding across all four channels,
and the empty-before-candidate rule under high load factors.
"""
import numpy as np
import pytest

from kmergutsjava_tpu.formats.kmer_table import build_table
from kmergutsjava_tpu.lookup.stream import CHANNELS, StreamLookup
from kmergutsjava_tpu.lookup.parity import lookup_stream
from test_lookup import canon, make_queries
from test_table import random_signatures


@pytest.mark.parametrize("seed,load,nq", [(0, 0.6, 3000), (1, 0.9, 6000)])
def test_stream_vs_parity(seed, load, nq):
    rng = np.random.default_rng(seed)
    sig = random_signatures(rng, 3000)
    table = build_table(**sig, load_factor=load)
    values, cnt, pos = make_queries(rng, sig["kmers"], nq)
    a = lookup_stream(table, values, cnt, pos)
    b = StreamLookup(table).lookup(values, cnt, pos)
    assert canon(a) == canon(b)
    assert a.kmers_found == b.kmers_found


def test_stream_dense_queries():
    """Query every signature (the kernel's target regime)."""
    rng = np.random.default_rng(7)
    sig = random_signatures(rng, 5000)
    table = build_table(**sig)
    v = sig["kmers"]
    a = lookup_stream(table, v, np.zeros(len(v)), np.arange(len(v)))
    b = StreamLookup(table).lookup(v, np.zeros(len(v)), np.arange(len(v)))
    assert len(b) == len(v)
    assert canon(a) == canon(b)


def test_stream_channel_overflow():
    """Many duplicate values share one home slot: ranks beyond C must take
    the exact fallback and still produce identical results."""
    rng = np.random.default_rng(11)
    sig = random_signatures(rng, 400)
    table = build_table(**sig)
    base = sig["kmers"][:8]
    values = np.concatenate([np.repeat(base, CHANNELS * 3),
                             rng.integers(0, 10**9, 200, dtype=np.int64)])
    rng.shuffle(values)
    cnt = np.arange(len(values), dtype=np.int64) % 5
    pos = np.arange(len(values), dtype=np.int64)
    a = lookup_stream(table, values, cnt, pos)
    b = StreamLookup(table).lookup(values, cnt, pos)
    assert canon(a) == canon(b)


def test_stream_eight_channels():
    """channels=8 (two packed output planes) matches the oracle, including
    ranks 4-7 of heavily colliding homes."""
    rng = np.random.default_rng(21)
    sig = random_signatures(rng, 2000)
    table = build_table(**sig)
    base = sig["kmers"][:40]
    values = np.concatenate([np.repeat(base, 6),
                             rng.integers(0, 10**9, 500, dtype=np.int64),
                             sig["kmers"]])
    rng.shuffle(values)
    cnt = np.arange(len(values), dtype=np.int64) % 9
    pos = np.arange(len(values), dtype=np.int64)
    a = lookup_stream(table, values, cnt, pos)
    b = StreamLookup(table, channels=8).lookup(values, cnt, pos)
    assert canon(a) == canon(b)


def test_stream_empty_input():
    rng = np.random.default_rng(3)
    sig = random_signatures(rng, 100)
    table = build_table(**sig)
    z = np.zeros(0, dtype=np.int64)
    assert len(StreamLookup(table).lookup(z, z, z)) == 0


@pytest.mark.parametrize("seed,n_chunks", [(3, 1), (4, 7), (5, 23)])
def test_streaming_stream_matches_oneshot(seed, n_chunks):
    """Chunk-by-chunk tile accumulation == one-shot scatter: the per-slot
    occupancy counter must carry collision ranks across chunk boundaries
    (same home hit from different chunks -> different channels)."""
    from kmergutsjava_tpu.lookup.stream import StreamingStreamLookup

    rng = np.random.default_rng(seed)
    sig = random_signatures(rng, 2000)
    table = build_table(**sig, load_factor=0.8)
    values, cnt, pos = make_queries(rng, sig["kmers"], 9000)
    # force cross-chunk collisions: many duplicates of the same homes
    values[::5] = values[0]
    lk = StreamLookup(table)
    a = lk.lookup(values, cnt, pos)
    s = StreamingStreamLookup(lk, compute_kmers_found=True)
    for part in np.array_split(np.arange(len(values)), n_chunks):
        s.add_batch(values[part], cnt[part], pos[part])
    b = s.finish()
    assert canon(a) == canon(b)
    assert a.kmers_found == b.kmers_found


def test_streaming_stream_empty():
    from kmergutsjava_tpu.lookup.stream import StreamingStreamLookup

    rng = np.random.default_rng(9)
    sig = random_signatures(rng, 500)
    table = build_table(**sig)
    s = StreamingStreamLookup(StreamLookup(table))
    assert len(s.finish()) == 0
    assert len(s.partial_hits()) == 0


def test_non_pow2_probe_window():
    """w rounds to a multiple of 8 (not a power of two): max_probe 29 ->
    32 shifts, max_probe 50 -> 56 not 64; results stay exact."""
    rng = np.random.default_rng(7)
    sig = random_signatures(rng, 30000)
    table = build_table(**sig, load_factor=0.9)
    table.compute_max_probe()
    assert 16 < table.max_probe <= 64  # fixture sanity (deterministic)
    lk = StreamLookup(table)
    assert lk.w % 8 == 0
    assert table.max_probe <= lk.w < table.max_probe + 8
    values, cnt, pos = make_queries(rng, sig["kmers"], 30000)
    a = lookup_stream(table, values, cnt, pos)
    assert canon(a) == canon(lk.lookup(values, cnt, pos))


@pytest.mark.parametrize("flush_limit,n_chunks,async_scatter",
                         [(500, 7, True), (1, 5, True), (10**9, 3, True),
                          (500, 7, False), (1, 5, False)])
def test_streaming_multipass_matches_oneshot(flush_limit, n_chunks,
                                             async_scatter):
    """Bounded-memory multi-pass (flush_limit queries per plane pass):
    hits and the cross-pass kmers-found union match the one-shot path,
    including duplicates that span pass boundaries (their dedup state
    resets with the tiles)."""
    from kmergutsjava_tpu.lookup.stream import StreamingStreamLookup

    rng = np.random.default_rng(41)
    sig = random_signatures(rng, 1500)
    table = build_table(**sig, load_factor=0.8)
    values, cnt, pos = make_queries(rng, sig["kmers"], 4000)
    values[::4] = values[0]  # duplicates across every pass
    lk = StreamLookup(table)
    a = lk.lookup(values, cnt, pos)
    s = StreamingStreamLookup(lk, compute_kmers_found=True,
                              flush_limit=flush_limit,
                              async_scatter=async_scatter)
    for part in np.array_split(np.arange(len(values)), n_chunks):
        s.add_batch(values[part], cnt[part], pos[part])
    b = s.finish()
    assert canon(a) == canon(b)
    assert a.kmers_found == b.kmers_found
    if flush_limit < len(values):
        assert len(s._passes) >= 2  # multi-pass actually engaged


def test_streaming_multipass_end_to_end(tmp_path):
    """Engine stream backend with a tiny input_size_limit: byte-identical
    report to the parity backend (which spills through the query store)."""
    import random as pyrandom

    from test_end_to_end import _random_corpus, run_engine
    from kmergutsjava_tpu.formats.table_tools import (
        signatures_from_proteins, write_data_dir)

    rng = pyrandom.Random(3)
    prots, triples, funcs = _random_corpus(rng, n_prot=25)
    write_data_dir(tmp_path / "d", signatures_from_proteins(triples), funcs)
    fasta = "".join(f">p{i}\n{p}\n" for i, p in enumerate(prots))
    kw = dict(aa=True, min_hits=2, input_size_limit=100,
              temp_dir=str(tmp_path / "t"))
    a = run_engine(tmp_path / "d", fasta, backend="parity", **kw)
    b = run_engine(tmp_path / "d", fasta, backend="stream", **kw)
    assert a == b
