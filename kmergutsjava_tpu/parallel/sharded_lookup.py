"""Multi-chip lookup: slot-range-sharded table + data-sharded queries.

The reference's scalability story is out-of-core disk streaming
(SURVEY.md §2.2); here it is a device-resident table sharded by
slot range across the ``table`` mesh axis, query batches sharded across the
``data`` axis, and a psum hit-merge:

- each table shard holds its slot slice plus a ``probe_window`` halo so any
  probe window whose home slot it owns is a local contiguous read;
- every device probes only the queries whose home falls in its slice
  (exactly one owner per query), contributing zeros otherwise;
- ``psum`` over the table axis assembles complete per-query answers on every
  data shard — collectives ride ICI, no host round-trips.

The device plane is the uint16 FINGERPRINT of the k-mer column
(``kmer % 65535``, sentinel 65535 = empty — the same plane design as the
single-chip fast paths, lookup/xla.py): 2 bytes per slot instead of the
8-byte int64 k-mer plane, so a device holds 4x the table and the
per-query gather reads 256 B instead of 1024 B. The device answer is ONE int32 per query — the
first-fingerprint-match slot + 1 (0 = no candidate) — which the host
VERIFIES against the full k-mer value (`verify_candidates`): a true match
always fingerprint-matches at-or-before itself, so candidates are a
superset of matches; the ~w/65535 fingerprint-collision rate re-probes an
exact full window host-side. Hit metadata (otu/avgFromEnd/fI/wt) is then
gathered from the table's host arrays at the verified slots, exactly like
the single-chip fingerprint backend, and the D2H transfer stays 4 bytes
per query.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..formats.kmer_table import KmerTable
from ..lookup.xla import FP_EMPTY, FP_MOD
from .mesh import DATA_AXIS, TABLE_AXIS


def shard_table_planes(table: KmerTable, n_shards: int, probe_window: int):
    """Host-side prep: per-shard slot-range slices of the uint16
    FINGERPRINT plane (+ probe halo) laid out in 128-lane overlapped
    rows, so every probe window is one or two contiguous row loads. Only
    2 bytes per slot ship to the device (the probe answers with a
    candidate slot; the host verifies it against the full k-mer value and
    gathers metadata — `verify_candidates` /
    `gather_hit_metadata`).

    Lane width: 128 by default; KMER_SHARD_LANES overrides.

    Overlapped layout (row r = local slots [r*stride, r*stride + lanes),
    stride = lanes - probe_window) so any window lies in ONE row.
    probe_window > 64 or an overlap past the byte budget falls back to
    plain 128-lane rows + two-row gathers ("stride" 0).
    """
    if probe_window > 128:
        raise ValueError("sharded lookup requires probe_window <= 128 "
                         "(two-row gather); rebuild the table at a lower "
                         "load factor")
    if table.num_sigs + probe_window >= 2**31 - 1:
        # the probe answer (candidate global slot + 1) rides the psum as
        # int32; a larger table would silently wrap to a wrong slot
        raise ValueError("sharded lookup encodes slots as int32; "
                         f"num_sigs={table.num_sigs} would overflow — "
                         "shard the table across hosts instead")
    import os

    s = table.num_sigs
    s_loc = -(-s // n_shards)
    slice_len = s_loc + probe_window
    lanes = int(os.environ.get("KMER_SHARD_LANES", 0)) or 128
    while lanes < 128 and lanes < 2 * probe_window:
        lanes *= 2
    stride = lanes - probe_window if probe_window <= 64 else 0
    if stride:
        # storage gate: the overlap factor (lanes/stride, up to 2x)
        # applies to the uint16 fingerprint plane (2 B/slot — the only
        # plane shipped to the device); a big table in these barely-fits
        # modes must not be inflated past the budget. Widening lanes
        # first cheapens the overlap (128/112 = 1.14x) before giving up.
        budget = int(os.environ.get("KMER_ROWS1_MAX_BYTES", 4 << 30))
        while (lanes < 128
               and ((s_loc - 1) // stride + 1) * lanes * 2 > budget):
            lanes *= 2
            stride = lanes - probe_window
        if ((s_loc - 1) // stride + 1) * lanes * 2 > budget:
            stride = 0
            lanes = 128
    if stride:
        rows_loc = (s_loc - 1) // stride + 1
        ext = (rows_loc - 1) * stride + lanes
    else:
        lanes = 128
        rows_loc = -(-slice_len // 128) + 1
        ext = rows_loc * 128
    total = n_shards * s_loc + slice_len
    fp = np.full(total, FP_EMPTY, dtype=np.uint16)
    occ = table.occupied
    fp[:s][occ] = (table.slots["kmer"][occ] % FP_MOD).astype(np.uint16)

    def window(a, fill):
        flat = np.full((n_shards, ext), fill, dtype=a.dtype)
        for i in range(n_shards):
            flat[i, :slice_len] = a[i * s_loc: i * s_loc + slice_len]
        if not stride:
            return flat.reshape(n_shards, rows_loc, lanes)
        it = a.dtype.itemsize
        rows = np.lib.stride_tricks.as_strided(
            flat, shape=(n_shards, rows_loc, lanes),
            strides=(flat.strides[0], stride * it, it))
        return np.ascontiguousarray(rows)

    return {"fp": window(fp, FP_EMPTY), "s_loc": s_loc,
            "stride": stride, "lanes": lanes}


def _local_probe(tk, qfp, homes, s_loc, probe_window, stride=0,
                 lanes=128):
    """Probe queries whose home falls in this shard's slice. Runs inside
    shard_map; the fingerprint plane's leading shard dim is squeezed to 1.
    ``qfp`` is the queries' uint16 fingerprint (value % 65535, any int
    dtype accepted) — the device never touches the int64 value at all
    (see ops/kmerize.kmer_window_mods).
    Row-gather formulation (no scalar gathers): with an overlapped layout
    (stride > 0, see shard_table_planes) the whole window lies in one
    `lanes`-wide row — one u16 row gather (256 B) per query; the plain
    layout needs two consecutive 128-lane rows. Returns the first
    FINGERPRINT-match GLOBAL slot + 1 per query (0 = no candidate),
    psum'ed over the table axis (each query has exactly one owner shard;
    the rest contribute 0). Candidates are a superset of true matches
    (equal values have equal fingerprints, and empty slots carry the
    FP_EMPTY sentinel no query fingerprint can equal); the host verifies
    and resolves collisions (`verify_candidates`)."""
    tk = tk[0]
    shard = jax.lax.axis_index(TABLE_AXIS)
    local = homes.astype(jnp.int32) - shard * s_loc
    mine = (local >= 0) & (local < s_loc)
    base = jnp.where(mine, local, 0)
    qfp = qfp.astype(jnp.uint16)
    big = jnp.int32(probe_window)
    if stride:
        r = base // jnp.int32(stride)
        o = base - r * jnp.int32(stride)
        win = jnp.take(tk, r, axis=0)  # [N, lanes] single row gather
        rel = jnp.arange(lanes, dtype=jnp.int32)[None, :] - o[:, None]
    else:
        r = jax.lax.shift_right_logical(base, jnp.int32(7))
        o = base & jnp.int32(127)
        win = jnp.concatenate([jnp.take(tk, r, axis=0),
                               jnp.take(tk, r + 1, axis=0)], axis=1)  # [N,256]
        rel = jnp.arange(256, dtype=jnp.int32)[None, :] - o[:, None]
    match = ((win == qfp[:, None])
             & (rel >= 0) & (rel < probe_window))
    off = jnp.min(jnp.where(match, rel, big), axis=1)
    found = (off < big) & mine
    slotp = jnp.where(found,
                      shard * s_loc + base + off + jnp.int32(1),
                      jnp.int32(0))
    return jax.lax.psum(slotp, TABLE_AXIS)


def make_sharded_lookup(mesh, table: KmerTable, probe_window: int
                        ) -> Tuple[Callable, dict]:
    """Build a jitted sharded lookup step and its device-ready fp plane.

    Returns (step, planes): step(fp, qfp, homes) -> candidate slot+1
    (0 = miss) with qfp/homes sharded over the data axis and the
    fingerprint plane sharded over the table axis — 6 B per query travel
    H2D (2 B fingerprint + 4 B home), no int64 on the device. The host
    verifies candidates and gathers metadata (`verify_candidates` /
    `gather_hit_metadata`).
    """
    n_shards = mesh.shape[TABLE_AXIS]
    planes = shard_table_planes(table, n_shards, probe_window)
    s_loc = planes["s_loc"]

    table_spec = P(TABLE_AXIS, None, None)
    query_spec = P(DATA_AXIS)

    fn = partial(_local_probe, s_loc=s_loc, probe_window=probe_window,
                 stride=planes["stride"], lanes=planes["lanes"])
    step = jax.jit(
        jax.shard_map(
            fn, mesh=mesh,
            in_specs=(table_spec, query_spec, query_spec),
            out_specs=query_spec,
        )
    )

    device_planes = {
        "fp": jax.device_put(planes["fp"],
                             NamedSharding(mesh, table_spec))
    }
    return step, device_planes


def verify_candidates(table: KmerTable, slotp: np.ndarray,
                      values: np.ndarray, probe_window: int):
    """Resolve fingerprint-candidate answers into exact matches.

    ``slotp``: the device's candidate slot+1 per query (0 = no candidate);
    ``values``: the queries' full k-mer values, aligned. Returns
    (found, slots): the exact first-value-match slot per query.

    A true match fingerprints equal, so the device candidate offset is
    <= the true offset; three cases per candidate:
    - stored kmer == value: the candidate IS the first value match
      (any earlier value match would have been an earlier fp match);
    - mismatch (fp collision, ~probe_window/65535 of queries): exact
      full-window host re-probe — the true match, if any, is later in
      the window;
    - no candidate: a true miss (a match implies a candidate).
    Slots past num_sigs (padded tail, reachable only by corrupted-input
    values equal to the empty sentinel) count as misses. The window scan
    treats beyond-end slots as empty, matching the padded host plane of
    the single-chip backends (lookup/xla.py host_kmer)."""
    slots = slotp.astype(np.int64) - 1
    cand = (slotp > 0) & (slots < table.num_sigs)
    tk = table.slots["kmer"]
    found = np.zeros(len(slots), dtype=bool)
    sel = np.nonzero(cand)[0]
    v = np.asarray(values, dtype=np.int64)
    found[sel] = tk[slots[sel]] == v[sel]
    bad = sel[~found[sel]]
    if len(bad):
        homes = (v[bad] % np.int64(table.num_sigs)).astype(np.int64)
        f2 = np.zeros(len(bad), dtype=bool)
        off2 = np.zeros(len(bad), dtype=np.int64)
        ns = table.num_sigs
        # reverse order + overwrite == first-match offset; beyond-end
        # reads clamp to a masked miss (treated as empty)
        for l in range(probe_window - 1, -1, -1):
            idx = homes + l
            ok = idx < ns
            m = ok & (tk[np.minimum(idx, ns - 1)] == v[bad])
            off2[m] = l
            f2 |= m
        found[bad] = f2
        slots[bad] = np.where(f2, homes + off2, 0)
    slots = np.where(found, slots, 0)
    return found, slots


def gather_hit_metadata(table: KmerTable, slotp: np.ndarray,
                        values: np.ndarray = None,
                        probe_window: int = None):
    """Host-side metadata gather at slot+1 answers (0 = miss). Returns
    (found_bool, otu, avg_from_end, fi, wt) aligned with the queries.
    With ``values`` given (the fingerprint-candidate protocol), answers
    are first verified and collision-resolved by `verify_candidates` —
    callers MUST drop rows where found is False. Without values the
    answers are trusted exact (legacy single-purpose uses); a slot in
    the padded tail past num_sigs still counts as a miss rather than
    indexing out of bounds."""
    if values is not None:
        if probe_window is None:
            if table.max_probe is None:
                table.compute_max_probe()
            probe_window = max(8, table.max_probe)
        found, slots = verify_candidates(table, slotp, values, probe_window)
    else:
        slots = slotp.astype(np.int64) - 1
        found = (slotp > 0) & (slots < table.num_sigs)
        slots = np.where(found, slots, 0)
    t = table.slots
    z32 = np.int32(0)
    return (found,
            np.where(found, t["otu"][slots], z32),
            np.where(found, t["avg_from_end"][slots], z32),
            np.where(found, t["fi"][slots], z32),
            np.where(found, t["wt"][slots], np.float32(0)))


def sharded_lookup_queries(mesh, step, device_planes, values: np.ndarray,
                           table: KmerTable, pad_multiple: int,
                           probe_window: int = None):
    """Host convenience: pad values to the data-shard multiple, run the
    device candidate probe, verify + gather metadata host-side."""
    n = len(values)
    n_data = mesh.shape[DATA_AXIS]
    mult = n_data * pad_multiple
    n_pad = -(-max(n, 1) // mult) * mult
    v = np.zeros(n_pad, dtype=np.int64)
    v[:n] = values
    homes = (v % np.int64(table.num_sigs)).astype(np.int32)
    qfp = (v % np.int64(FP_MOD)).astype(np.uint16)
    # padding rows have value 0 / home 0; they may return a candidate for
    # kmer 0 but are sliced off below
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    q_dev = jax.device_put(qfp, sharding)
    h_dev = jax.device_put(homes, sharding)
    slotp = step(device_planes["fp"], q_dev, h_dev)
    from .multihost import fetch_global

    slotp = fetch_global(slotp)[:n]
    return gather_hit_metadata(table, slotp, values=v[:n],
                               probe_window=probe_window)
