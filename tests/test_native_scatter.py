"""Native C++ dense-tile scatter (kmergutsjava_tpu/native/scatter.cpp) vs the numpy path.

The two scatters may assign channel ranks differently (encounter order vs
value order), so equality is asserted at the hits level — the contract both
must satisfy — plus direct structural invariants on the native outputs.
"""
import numpy as np
import pytest

from kmergutsjava_tpu.formats.kmer_table import build_table
from kmergutsjava_tpu.lookup.stream import (
    BLOCK, ROWS, StreamLookup, StreamingStreamLookup)
from kmergutsjava_tpu.lookup.xla import FP_MOD
from kmergutsjava_tpu.utils.native import load_scatter
from test_lookup import canon, make_queries
from test_table import random_signatures

pytestmark = pytest.mark.skipif(load_scatter() is None,
                                reason="native scatter unavailable")


def force_numpy(lk: StreamLookup) -> StreamLookup:
    lk._scatter_dense = lambda *a, **kw: lk._scatter_dense_numpy(*a, **kw)
    lk._decode = lambda *a, **kw: lk._decode_numpy(*a, **kw)
    return lk


@pytest.mark.parametrize("seed,load,nq", [(0, 0.6, 4000), (1, 0.9, 8000)])
def test_native_vs_numpy_hits(seed, load, nq):
    rng = np.random.default_rng(seed)
    sig = random_signatures(rng, 3000)
    table = build_table(**sig, load_factor=load)
    values, cnt, pos = make_queries(rng, sig["kmers"], nq)
    values[::7] = values[0]  # heavy duplication
    a = force_numpy(StreamLookup(table)).lookup(values, cnt, pos)
    b = StreamLookup(table).lookup(values, cnt, pos)
    assert canon(a) == canon(b)
    assert a.kmers_found == b.kmers_found


def test_native_vs_numpy_channel_overflow():
    """Same home slot hammered past C channels: overflow split may differ
    between the two scatters but the merged hits must not."""
    rng = np.random.default_rng(5)
    sig = random_signatures(rng, 500)
    table = build_table(**sig)
    base = sig["kmers"][:6]
    values = np.concatenate([
        np.repeat(base, 40),
        base + np.int64(table.num_sigs),      # same homes, different values
        rng.integers(0, 10**9, 300, dtype=np.int64)])
    rng.shuffle(values)
    cnt = np.arange(len(values), dtype=np.int64) % 4
    pos = np.arange(len(values), dtype=np.int64)
    a = force_numpy(StreamLookup(table)).lookup(values, cnt, pos)
    b = StreamLookup(table).lookup(values, cnt, pos)
    assert canon(a) == canon(b)


@pytest.mark.parametrize("n_chunks", [1, 9])
def test_streaming_native_matches_numpy_oneshot(n_chunks):
    rng = np.random.default_rng(13)
    sig = random_signatures(rng, 2000)
    table = build_table(**sig, load_factor=0.8)
    values, cnt, pos = make_queries(rng, sig["kmers"], 9000)
    values[::5] = values[1]
    a = force_numpy(StreamLookup(table)).lookup(values, cnt, pos)
    s = StreamingStreamLookup(StreamLookup(table),
                              compute_kmers_found=True)
    for part in np.array_split(np.arange(len(values)), n_chunks):
        s.add_batch(values[part], cnt[part], pos[part])
    b = s.finish()
    assert canon(a) == canon(b)
    assert a.kmers_found == b.kmers_found


class threads:
    """Pin KMER_NATIVE_THREADS for the duration (getenv is per-call)."""

    def __init__(self, n):
        self.n = str(n)

    def __enter__(self):
        import os
        self.old = os.environ.get("KMER_NATIVE_THREADS")
        os.environ["KMER_NATIVE_THREADS"] = self.n

    def __exit__(self, *a):
        import os
        if self.old is None:
            del os.environ["KMER_NATIVE_THREADS"]
        else:
            os.environ["KMER_NATIVE_THREADS"] = self.old


def test_scatter_mt_bit_identical_to_sequential():
    """The threaded scatter (radix partition by home range) must produce
    EXACTLY the sequential outputs: tiles, occupancy, flat, shift, placed.
    n must exceed the 65536 sequential cutoff to engage the MT path."""
    lib = load_scatter()
    rng = np.random.default_rng(23)
    sig = random_signatures(rng, 30_000)
    table = build_table(**sig, load_factor=0.8)
    lk = StreamLookup(table)
    values, _, _ = make_queries(rng, sig["kmers"], 200_000)
    values[::3] = values[1]          # heavy duplication
    values[1::7] = values[4]
    chunks = np.array_split(values, 2)   # streaming continuation too

    def run(nthreads):
        tiles = np.zeros((lk.nsuper, lk.channels, ROWS, BLOCK),
                         dtype=np.uint16)
        occ = np.zeros(lk.num_sigs, dtype=np.uint8)
        outs = []
        with threads(nthreads):
            for ch in chunks:
                outs.append(lk._scatter_dense_native(
                    lib, np.ascontiguousarray(ch), tiles, occ))
        return tiles, occ, outs

    t1, o1, r1 = run(1)
    t4, o4, r4 = run(4)
    assert np.array_equal(t1, t4)
    assert np.array_equal(o1, o4)
    for (_, h1, f1, s1), (_, h4, f4, s4) in zip(r1, r4):
        assert np.array_equal(h1, h4)
        assert np.array_equal(f1, f4)
        assert np.array_equal(s1, s4)


def test_decode_mt_bit_identical_to_sequential():
    """The threaded decode (slice-parallel resolve + offset compaction)
    must emit exactly the sequential hit columns, in the same order.
    Random kernel output bytes exercise every branch (verification
    failures, stop-at-empty, fallback window probes, overflow)."""
    lib = load_scatter()
    rng = np.random.default_rng(29)
    sig = random_signatures(rng, 20_000)
    table = build_table(**sig, load_factor=0.9)
    lk = StreamLookup(table)
    n = 150_000
    values, cnt, pos = make_queries(rng, sig["kmers"], n)
    _, homes, flat, shift = lk._scatter_dense_native(
        lib, np.ascontiguousarray(values))
    shift[::11] = -1                 # force some overflow-path queries
    out_sz = lk.nsuper * (lk.channels // 4) * ROWS * BLOCK
    out = rng.integers(0, 2**31, out_sz, dtype=np.int32)  # random offsets
    chunk = (values, cnt, pos, homes, flat, shift)
    with threads(1):
        a = lk._decode_native(lib, out, [chunk], n, None, True,
                              want_values=True)
    with threads(4):
        b = lk._decode_native(lib, out, [chunk], n, None, True,
                              want_values=True)
    for x, y in zip((a[0].cnt_id, a[0].pos, a[0].otu, a[0].avg_from_end,
                     a[0].fi, a[0].wt, a[1]),
                    (b[0].cnt_id, b[0].pos, b[0].otu, b[0].avg_from_end,
                     b[0].fi, b[0].wt, b[1])):
        assert np.array_equal(x, y)
    assert a[0].kmers_found == b[0].kmers_found


def test_native_scatter_invariants():
    """Structural checks on the raw native outputs: placed queries' flat
    index + shift decode back to their home slot and tile fingerprint;
    duplicates share a cell; per-home placements never exceed C."""
    rng = np.random.default_rng(17)
    sig = random_signatures(rng, 1500)
    table = build_table(**sig)
    lk = StreamLookup(table)
    values, _, _ = make_queries(rng, sig["kmers"], 5000)
    values[::3] = values[2]
    tiles, homes, flat, shift = lk._scatter_dense_native(
        load_scatter(), values)
    assert np.array_equal(homes, values % np.int64(lk.num_sigs))
    ok = shift >= 0
    planes = lk.channels // 4
    fl, sh = flat[ok], shift[ok]
    within = fl % BLOCK
    row = (fl // BLOCK) % ROWS
    rest = fl // (BLOCK * ROWS)
    p = rest % planes
    sup = rest // planes
    rk = 4 * p + sh // 8
    blk = sup * ROWS + row
    assert np.array_equal(blk * BLOCK + within, homes[ok])
    got_fp = tiles[sup, rk, row, within]
    assert np.array_equal(got_fp, (values[ok] % FP_MOD).astype(np.uint16))
    # duplicates share one cell
    dup = ok & (values == values[2])
    assert dup.any()
    cells = set(zip(flat[dup].tolist(), shift[dup].tolist()))
    assert len(cells) == 1
    # distinct tile cells used per home never exceed C (values may share a
    # cell: equal values always do, fp-colliding values occasionally do)
    cells_per_home = {}
    for h, f, s_ in zip(homes[ok].tolist(), fl.tolist(), sh.tolist()):
        cells_per_home.setdefault(h, set()).add((f, s_))
    assert max(len(s) for s in cells_per_home.values()) <= lk.channels


def test_bin_queries_native_matches_numpy_and_threads():
    """Native bin router == numpy stable-argsort twin, at every thread
    count, incl. the overflow regime (rank >= cap)."""
    import os

    import numpy as np

    from kmergutsjava_tpu.utils.native import bin_queries_native

    rng = np.random.default_rng(41)
    stride, chunk_rows, n_chunks, cap = 112, 64, 12, 40
    span = stride * chunk_rows
    n = 5000
    homes = rng.integers(0, n_chunks * span - 200, n).astype(np.int32)
    homes[:2000] = rng.integers(0, span, 2000)  # skew chunk 0 -> overflow
    q_fp = rng.integers(0, 65536, n).astype(np.uint16)

    # numpy twin (the exact code path XlaLookup falls back to)
    c = (homes // span).astype(np.int64)
    order = np.argsort(c.astype(np.uint8), kind="stable")
    c_s = c[order]
    counts = np.bincount(c_s, minlength=n_chunks)
    starts = np.zeros(n_chunks, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    rank = np.arange(n, dtype=np.int64) - starts[c_s]
    homes_s = homes[order]
    r_s = homes_s // stride
    want_q = np.zeros((n_chunks, cap), np.uint16)
    want_r = np.zeros((n_chunks, cap), np.uint16)
    want_o = np.zeros((n_chunks, cap), np.uint8)
    ok = rank < cap
    want_q[c_s[ok], rank[ok]] = q_fp[order][ok]
    want_r[c_s[ok], rank[ok]] = (r_s - c_s * chunk_rows)[ok]
    want_o[c_s[ok], rank[ok]] = (homes_s - r_s * stride)[ok]
    want_rank = np.empty(n, np.int64)
    want_rank[order] = rank

    outs = []
    for threads in ("1", "2", "5"):
        os.environ["KMER_NATIVE_THREADS"] = threads
        try:
            got = bin_queries_native(homes, q_fp, stride, chunk_rows,
                                     n_chunks, cap)
        finally:
            del os.environ["KMER_NATIVE_THREADS"]
        if got is None:
            import pytest

            pytest.skip("no native toolchain")
        outs.append(got)
    for qb, rb, ob, cof, rof in outs:
        assert np.array_equal(qb, want_q)
        assert np.array_equal(rb, want_r)
        assert np.array_equal(ob, want_o)
        assert np.array_equal(cof, c)
        assert np.array_equal(rof, want_rank)
    assert (want_rank >= cap).any()  # the overflow regime was exercised
