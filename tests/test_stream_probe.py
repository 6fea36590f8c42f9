"""The dense stream probe (lookup/stream.py) vs the parity oracle across
load factors, scan windows and channel counts, and its sharded form on
2, 4 and 8 virtual devices."""
import numpy as np
import pytest

from kmergutsjava_tpu.formats.kmer_table import build_table
from kmergutsjava_tpu.lookup.parity import lookup_stream
from kmergutsjava_tpu.lookup.stream import BLOCK, HALO, StreamLookup
from kmergutsjava_tpu.parallel.stream_shards import (StreamShardedLookup,
                                                     make_stream_mesh)
from test_lookup import canon, make_queries
from test_table import random_signatures


def stress_queries(rng, table, sig, channels, n=4000):
    """Random hits and misses, plus the probe's edge cases: distinct values
    sharing one home slot beyond the channel count (channel overflow),
    and homes in the last HALO slots of a block row, whose windows run
    into the row's halo copy of the next row."""
    s = np.int64(table.num_sigs)
    values, _, _ = make_queries(rng, sig["kmers"], n)
    homes = rng.integers(0, table.num_sigs, 6)
    over = (homes[:, None] + s * np.arange(1, 3 * channels + 1)).ravel()
    row_end = [h for h in range(BLOCK - HALO, table.num_sigs, BLOCK)
               for h in (h, h + HALO - 1) if h < table.num_sigs]
    row_end = np.asarray(row_end, np.int64)
    occ = table.occupied
    tail_hits = table.slots["kmer"][row_end[occ[row_end]]]
    values = np.concatenate([values, over, row_end + s, tail_hits])
    rng.shuffle(values)
    cnt = rng.integers(0, 9, len(values)).astype(np.int64)
    return values, cnt, np.arange(len(values), dtype=np.int64)


@pytest.mark.parametrize("channels", [4, 8])
@pytest.mark.parametrize("window", [8, 24, 64])
@pytest.mark.parametrize("load", [0.3, 0.6, 0.85])
def test_stream_probe_vs_parity(load, window, channels):
    rng = np.random.default_rng(int(load * 100) + window + channels)
    sig = random_signatures(rng, 9000)
    table = build_table(**sig, load_factor=load)
    lk = StreamLookup(table, channels=channels, window=window)
    assert lk.w == window
    values, cnt, pos = stress_queries(rng, table, sig, channels)
    a = lookup_stream(table, values, cnt, pos)
    b = lk.lookup(values, cnt, pos)
    assert canon(a) == canon(b)
    assert a.kmers_found == b.kmers_found


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_stream_probe_matches_single_and_parity(n_shards):
    rng = np.random.default_rng(50 + n_shards)
    sig = random_signatures(rng, 60000)
    table = build_table(**sig, load_factor=0.7)
    sharded = StreamShardedLookup(table, mesh=make_stream_mesh(n_shards))
    assert len(sharded.fp_blocks.sharding.device_set) == n_shards
    single = StreamLookup(table)
    values, cnt, pos = stress_queries(rng, table, sig, 4, n=30000)
    tiles = single._scatter_dense(values)[0]
    tiles_sh = sharded._scatter_dense(values)[0]
    out = np.asarray(single._probe(tiles))
    out_sh = np.asarray(sharded._probe(tiles_sh))
    # the sharded plane pads the superblock count to a multiple of the
    # shard count; the padding superblocks hold no slots
    assert np.array_equal(out, out_sh[:single.nsuper])
    a = lookup_stream(table, values, cnt, pos)
    b = sharded.lookup(values, cnt, pos)
    assert canon(a) == canon(b)
    assert a.kmers_found == b.kmers_found


def test_stream_mesh_needs_enough_devices():
    import jax

    with pytest.raises(ValueError, match="devices"):
        make_stream_mesh(len(jax.devices()) + 1)
