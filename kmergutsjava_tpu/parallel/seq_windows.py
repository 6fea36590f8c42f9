"""Sequence parallelism: long contigs split into overlapping device windows.

The reference handles arbitrarily long contigs sequentially — a 4.6 Mbp
contig is one char array walked frame by frame (processSeq,
KmerGutsJava.java:538-558). The SPMD
annotate step (parallel/annotate_step.py) places whole contigs on data
shards, which caps parallelism at the contig count; this module completes
the SURVEY §2.2 "sequence parallelism analog": ONE contig is split into
fixed-size windows with a 24-base overlap (one aa 8-mer = 3*K bases) so
translation + k-mer extraction stay shape-static, the windows shard over
the ``data`` mesh axis, and hit positions map back to exact global frame
coordinates — hit grouping re-fuses the windows with no seam effects.

Exactness argument (tests/test_seq_windows.py pins it differentially
against the host prepare + parity lookup):

- windows start at multiples of 3, so window-local forward frame f IS
  global frame f shifted by start/3 codons;
- the reverse strand is the reference's revComp-then-translate
  (ref :1063-1072): window [s, e) of the contig is slice [L-e, L-s) of the
  global reverse complement, so window-local rc frame (f - (L-e)) mod 3
  is global rc frame f shifted by (L - e + f' - f)/3 codons;
- every global 8-mer occupies exactly 24 bases of its strand; the window
  whose 24-base-aligned stride bucket contains the k-mer's lowest original
  base coordinate OWNS it (last window owns its tail), and the >= 24-base
  overlap guarantees the owner window contains all 24 bases — each global
  k-mer is emitted exactly once, with its exact (container, protein
  position);
- DNA frames have no skip-last-window quirk: the reference's ``i < len-K``
  bound over its len/3+1 buffer admits every full codon window
  (models/prepare.py), so local 8-aa validity == global validity.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..constants import K
from ..formats.kmer_table import KmerTable
from ..ops.hostvalues import aa_values_at, dna_values_at
from .mesh import DATA_AXIS, TABLE_AXIS
from .sharded_lookup import _local_probe, shard_table_planes

OVERLAP_NT = 3 * K  # one aa 8-mer spans 24 bases of its strand
_BIG = np.int32(2 ** 30)


def plan_windows(length: int, win_nt: int) -> dict:
    """Host-side plan for one contig: window byte ranges plus, per
    (window, global container g in +0+1+2-0-1-2 order), the local frame
    row, the global codon offset, and the owned local-window interval.

    Returns numpy arrays: s/e/len_w [n_win]; row_map/j0/own_start/own_end
    [n_win, 6] (own_end exclusive; empty intervals where a window owns
    nothing in a frame).
    """
    if win_nt % 3 or win_nt <= OVERLAP_NT:
        raise ValueError("win_nt must be a multiple of 3 greater than 24")
    L = int(length)
    stride = win_nt - OVERLAP_NT
    n_win = max(L - OVERLAP_NT, 0) // stride + 1
    s = np.arange(n_win, dtype=np.int64) * stride
    e = np.minimum(s + win_nt, L)
    row_map = np.zeros((n_win, 6), np.int32)
    j0 = np.zeros((n_win, 6), np.int64)
    own_start = np.zeros((n_win, 6), np.int64)
    own_end = np.zeros((n_win, 6), np.int64)
    last = n_win - 1
    for f in range(3):
        # forward: local frame f == global frame f at codon offset s/3
        row_map[:, f] = f
        j0[:, f] = s // 3
        # owned anchors a = s + f + 3j'' with a in [s, s+stride)
        own_end[:, f] = (stride - f + 2) // 3
        own_end[last, f] = _BIG  # the tail has no next window
        # reverse: window [s,e) == global revComp slice [L-e, L-s)
        g = 3 + f
        fp = (f - (L - e)) % 3
        row_map[:, g] = 3 + fp
        j0[:, g] = (L - e + fp - f) // 3
        # owned anchors a = L - f - 3*(j0+j'') - 24 in [s, s+stride)
        t = L - f - 3 * j0[:, g] - OVERLAP_NT - s
        own_end[:, g] = t // 3 + 1
        own_start[:, g] = (t - stride) // 3 + 1
        own_start[last, g] = 0  # the tail (smallest j'') has no next window
    np.clip(own_start, 0, None, out=own_start)
    np.clip(own_end, 0, None, out=own_end)
    return {"s": s, "e": e, "len_w": e - s, "stride": stride,
            "row_map": row_map, "j0": j0,
            "own_start": own_start, "own_end": own_end}


def _window_probe(tk, ascii_u8, len_w, row_map,
                  own_start, own_end, *, s_loc, probe_window, num_sigs,
                  tbl_stride, tbl_lanes=128):
    """Per-device body: translate windows, reorder rows into global
    container order, kmerize, mask to owned intervals, probe. Returns
    per-(window, container, local-window) slot+1 (0 = miss)."""
    from ..ops.translate import translate_6frames

    frames = jax.vmap(translate_6frames)(ascii_u8, len_w)  # [B, 6, m]
    sel = jnp.take_along_axis(frames, row_map[:, :, None], axis=1)
    b, _, m = sel.shape
    w = m - K + 1
    offs = sel.reshape(b * 6, m)
    # every full window is a valid start here (DNA semantics); ownership
    # intervals below do the global bounding
    from .annotate_step import _window_homes_qfp

    homes, qfp, ok = _window_homes_qfp(
        offs, jnp.full((b * 6,), w, jnp.int32), num_sigs)
    jj = jnp.arange(w, dtype=jnp.int32)[None, None, :]
    ok = (ok.reshape(b, 6, w) & (jj >= own_start[:, :, None])
          & (jj < own_end[:, :, None]))
    slotp = _local_probe(tk, qfp.reshape(-1), homes.reshape(-1),
                         s_loc=s_loc, probe_window=probe_window,
                         stride=tbl_stride, lanes=tbl_lanes)
    return (slotp * ok.reshape(-1).astype(jnp.int32)).reshape(b, 6, w)


def make_windowed_dna_step(mesh, table: KmerTable, probe_window: int,
                           win_nt: int) -> Tuple[callable, dict]:
    """Sequence-parallel DNA SPMD step: windows sharded over ``data``, the
    table over ``table``. step(kmer, ascii_u8[W, win_nt], len_w[W],
    row_map[W, 6], own_start[W, 6], own_end[W, 6]) -> per-(window,
    container, local-window) slot+1 (0 = miss)."""
    if win_nt % 3:
        raise ValueError("win_nt must be a multiple of 3")
    n_shards = mesh.shape[TABLE_AXIS]
    planes = shard_table_planes(table, n_shards, probe_window)
    fn = partial(_window_probe, s_loc=planes["s_loc"],
                 probe_window=probe_window, num_sigs=table.num_sigs,
                 tbl_stride=planes["stride"], tbl_lanes=planes["lanes"])
    table_spec = P(TABLE_AXIS, None, None)
    d1 = P(DATA_AXIS)
    d2 = P(DATA_AXIS, None)
    step = jax.jit(
        jax.shard_map(
            fn, mesh=mesh,
            in_specs=(table_spec, d2, d1, d2, d2, d2),
            out_specs=P(DATA_AXIS, None, None),
        )
    )
    device_planes = {
        "fp": jax.device_put(planes["fp"],
                             NamedSharding(mesh, table_spec))
    }
    return step, device_planes


OVERLAP_AA = K - 1  # aa-mode window overlap: 7 aa (SURVEY §2.2)


def plan_aa_windows(length: int, win_aa: int) -> dict:
    """Window plan for one PROTEIN: aa windows overlapping by K-1 = 7, so
    every global 8-aa window lies whole in exactly one owner window. The
    reference's ``i < len - K`` bound (ref :912 — the final full window of
    a protein is SKIPPED, a parity quirk) becomes a per-window start
    count: num_starts[w] = clamp(L - K - s_w, 0, stride) with the last
    window unclamped above."""
    if win_aa <= OVERLAP_AA:
        raise ValueError("win_aa must be greater than 7")
    L = int(length)
    stride = win_aa - OVERLAP_AA  # == win_aa - K + 1 = local start capacity
    n_win = max(L - K - 1, 0) // stride + 1  # anchors i in [0, L-K-1]
    s = np.arange(n_win, dtype=np.int64) * stride
    e = np.minimum(s + win_aa, L)
    num_starts = np.maximum(L - K - s, 0)
    num_starts[:-1] = np.minimum(num_starts[:-1], stride)
    return {"s": s, "e": e, "len_w": e - s, "stride": stride,
            "num_starts": num_starts}


def windowed_protein_hits(mesh, step, device_planes, table: KmerTable,
                          seq_ascii: np.ndarray, win_aa: int,
                          probe_window: int = None):
    """Host driver: one long protein through the aa annotate step, windowed.

    ``step``/``device_planes`` come from annotate_step.
    make_sharded_annotate_step — its body computes num_starts as
    ``lengths - K``, so passing synthetic lengths = num_starts + K makes
    the unmodified aa step enforce each window's exact global start count
    (including the reference's skip-last-window quirk at the true end).
    Returns (pos, otu, avg_from_end, fi, wt) in global protein coordinates
    for the protein's single container (metadata gathered host-side from
    ``table`` at the device's slot answers).
    """
    from .sharded_lookup import gather_hit_metadata

    L = len(seq_ascii)
    plan = plan_aa_windows(L, win_aa)
    n_win = len(plan["s"])
    n_data = mesh.shape[DATA_AXIS]
    n_pad = -(-n_win // n_data) * n_data
    a = np.full((n_pad, win_aa), ord("*"), np.uint8)  # invalid aa pad
    for i in range(n_win):
        a[i, : plan["len_w"][i]] = seq_ascii[plan["s"][i]: plan["e"][i]]
    lengths = np.zeros(n_pad, np.int64)
    lengths[:n_win] = plan["num_starts"] + K
    slotp = step(
        device_planes["fp"],
        jax.device_put(a, NamedSharding(mesh, P(DATA_AXIS, None))),
        jax.device_put(lengths, NamedSharding(mesh, P(DATA_AXIS))))
    from .multihost import fetch_global

    slotp = np.asarray(fetch_global(slotp))[:n_win]
    wi, ji = np.nonzero(slotp)
    pos = plan["s"][wi] + ji
    # fingerprint-candidate protocol: recompute the query values at the
    # global positions, verify, drop resolved misses
    vals = aa_values_at(seq_ascii[None, :], np.zeros(len(pos), np.int64),
                        pos)
    found, otu, avg, fi, wt = gather_hit_metadata(table, slotp[wi, ji],
                                                  values=vals,
                                                  probe_window=probe_window)
    pos = pos[found]
    return (pos.astype(np.int64), otu[found], avg[found], fi[found],
            wt[found])


def windowed_contig_hits(mesh, step, device_planes, table: KmerTable,
                         seq_ascii: np.ndarray, win_nt: int,
                         probe_window: int = None):
    """Host driver: run one contig through the windowed step.

    seq_ascii: uint8 ASCII bases. Returns hit columns in global frame
    coordinates: (container g in 0..5 reference order, protein position,
    otu, avg_from_end, fi, wt) — ready for the per-container grouping
    machine (calls/grouping.py), which re-fuses the windows exactly.
    Metadata is gathered host-side from ``table`` at the device's slot
    answers.
    """
    from .sharded_lookup import gather_hit_metadata

    L = len(seq_ascii)
    plan = plan_windows(L, win_nt)
    n_win = len(plan["s"])
    n_data = mesh.shape[DATA_AXIS]
    n_pad = -(-n_win // n_data) * n_data
    a = np.full((n_pad, win_nt), ord("N"), np.uint8)  # invalid base pad
    for i in range(n_win):
        a[i, : plan["len_w"][i]] = seq_ascii[plan["s"][i]: plan["e"][i]]
    len_w = np.zeros(n_pad, np.int32)
    len_w[:n_win] = plan["len_w"]
    pad6 = lambda x, fill=0: np.concatenate(
        [x.astype(np.int32), np.full((n_pad - n_win, 6), fill, np.int32)])
    row_map = pad6(plan["row_map"])
    own_start = pad6(plan["own_start"])
    own_end = pad6(plan["own_end"])  # padding windows own nothing (end=0)
    ds1 = NamedSharding(mesh, P(DATA_AXIS))
    ds2 = NamedSharding(mesh, P(DATA_AXIS, None))
    slotp = step(
        device_planes["fp"],
        jax.device_put(a, ds2), jax.device_put(len_w, ds1),
        jax.device_put(row_map, ds2), jax.device_put(own_start, ds2),
        jax.device_put(own_end, ds2))
    from .multihost import fetch_global

    slotp = np.asarray(fetch_global(slotp))[:n_win]
    wi, gi, ji = np.nonzero(slotp)
    pos = plan["j0"][wi, gi] + ji
    # fingerprint-candidate protocol: global container + protein position
    # map straight to nucleotide coordinates of the one contig
    vals = dna_values_at(seq_ascii[None, :], np.array([L], np.int64),
                         np.zeros(len(pos), np.int64), gi, pos)
    found, otu, avg, fi, wt = gather_hit_metadata(table, slotp[wi, gi, ji],
                                                  values=vals,
                                                  probe_window=probe_window)
    gi, pos = gi[found], pos[found]
    return (gi.astype(np.int64), pos.astype(np.int64), otu[found],
            avg[found], fi[found], wt[found])
