"""Full sharded annotation step: encode -> kmerize -> probe -> hit merge.

One jitted SPMD program over a (data, table) mesh — the framework's
"training step" analog. Protein batches are sharded over the data axis,
the signature k-mer plane over the table axis; each device encodes its
local sequences, packs 8-mers, probes the slot range it owns, and a psum
over the table axis assembles the per-window answer — the first
FINGERPRINT-match slot + 1 (0 = no candidate) — on every data shard. The
host verifies each candidate against the recomputed query value and
gathers hit metadata (sharded_lookup.verify_candidates /
gather_hit_metadata, ops/hostvalues.py), so only the 2-byte-per-slot
uint16 fingerprint plane occupies device memory (4x the table per
device vs an int64 plane) and 4 bytes per window travel back.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..constants import AA_OFF_LUT, K
from ..formats.kmer_table import KmerTable
from ..lookup.xla import FP_MOD
from ..ops.encode import byte_lut
from ..ops.kmerize import MOD32_LIMIT, kmer_window_mods, kmer_windows
from .mesh import DATA_AXIS, TABLE_AXIS
from .sharded_lookup import _local_probe, shard_table_planes


def _window_homes_qfp(offs, num_starts, num_sigs):
    """(homes, qfp, ok) per window — int32-only whenever the table
    allows it (num_sigs <= MOD32_LIMIT ~ 97.6M slots, i.e. every
    production table; see ops/kmerize.kmer_window_mods). Beyond the limit
    the int64 path remains, pinned identical by tests/test_hostvalues.py."""
    if num_sigs <= MOD32_LIMIT:
        (homes, qfp), ok = kmer_window_mods(offs, num_starts,
                                            (num_sigs, FP_MOD))
        return homes, qfp, ok
    values, ok = kmer_windows(offs, num_starts)
    homes = (values % num_sigs).astype(jnp.int32)
    qfp = (values % jnp.asarray(FP_MOD, values.dtype)).astype(jnp.int32)
    return homes, qfp, ok


def _encode_and_probe(tk, ascii_u8, lengths,
                      *, s_loc, probe_window, num_sigs, stride=0,
                      lanes=128):
    """Per-device body (runs inside shard_map)."""
    # encode via the 256-entry byte LUT
    offs = byte_lut(np.asarray(AA_OFF_LUT), ascii_u8.astype(jnp.int32))
    b, n = offs.shape
    w = n - K + 1
    # reference window bound: i < len - K (ref KmerGutsJava.java:912)
    homes, qfp, ok = _window_homes_qfp(offs, lengths - K, num_sigs)
    slotp = _local_probe(tk, qfp.reshape(-1), homes.reshape(-1),
                         s_loc=s_loc, probe_window=probe_window,
                         stride=stride, lanes=lanes)
    return (slotp * ok.reshape(-1).astype(jnp.int32)).reshape(b, w)


def make_sharded_annotate_step(mesh, table: KmerTable, probe_window: int
                               ) -> Tuple[Callable, dict]:
    """Returns (step, device_planes). step(fp, ascii_u8[B, L],
    lengths[B]) -> per-window candidate slot+1 (0 = miss), with B sharded
    over the data axis; host verification + metadata via
    sharded_lookup.gather_hit_metadata(values=...)."""
    n_shards = mesh.shape[TABLE_AXIS]
    planes = shard_table_planes(table, n_shards, probe_window)
    fn = partial(_encode_and_probe, s_loc=planes["s_loc"],
                 probe_window=probe_window, num_sigs=table.num_sigs,
                 stride=planes["stride"], lanes=planes["lanes"])
    table_spec = P(TABLE_AXIS, None, None)
    step = jax.jit(
        jax.shard_map(
            fn, mesh=mesh,
            in_specs=(table_spec, P(DATA_AXIS, None), P(DATA_AXIS)),
            out_specs=P(DATA_AXIS, None),
        )
    )
    device_planes = {
        "fp": jax.device_put(planes["fp"],
                             NamedSharding(mesh, table_spec))
    }
    return step, device_planes


def _dna_encode_and_probe(tk, ascii_u8, lengths,
                          *, s_loc, probe_window, num_sigs, stride=0,
                          lanes=128):
    """DNA per-device body: 6-frame translate -> kmerize -> probe -> psum.

    ascii_u8: [B_loc, Lpad] contigs; lengths [B_loc]. Lpad need not be a
    multiple of 3 — translation bounds every frame by ``lengths`` and pads
    out-of-range reads with invalid codes (the spmd backend feeds
    power-of-two buckets).
    Returns per-(contig, frame-row, window) hit fields with frame rows in
    the reference's container order (+0,+1,+2,-0,-1,-2).
    """
    from ..ops.translate import translate_6frames

    frames = jax.vmap(translate_6frames)(ascii_u8, lengths)  # [B, 6, Lpad//3]
    b = frames.shape[0]
    m = frames.shape[2]
    w = m - K + 1
    offs = frames.reshape(b * 6, m)
    num_starts = jnp.maximum(lengths // 3 - K + 1, 0)  # ref :912 over len/3+1
    homes, qfp, ok = _window_homes_qfp(offs, jnp.repeat(num_starts, 6),
                                       num_sigs)
    slotp = _local_probe(tk, qfp.reshape(-1), homes.reshape(-1),
                         s_loc=s_loc, probe_window=probe_window,
                         stride=stride, lanes=lanes)
    return (slotp * ok.reshape(-1).astype(jnp.int32)).reshape(b, 6, w)


def make_sharded_dna_step(mesh, table: KmerTable, probe_window: int
                          ) -> Tuple[Callable, dict]:
    """Full DNA SPMD step: contigs sharded over data, table over table.
    step(fp, ascii_u8[B, Lpad], lengths[B]) -> per-(contig, frame,
    window) candidate slot+1 (0 = miss)."""
    n_shards = mesh.shape[TABLE_AXIS]
    planes = shard_table_planes(table, n_shards, probe_window)
    fn = partial(_dna_encode_and_probe, s_loc=planes["s_loc"],
                 probe_window=probe_window, num_sigs=table.num_sigs,
                 stride=planes["stride"], lanes=planes["lanes"])
    table_spec = P(TABLE_AXIS, None, None)
    step = jax.jit(
        jax.shard_map(
            fn, mesh=mesh,
            in_specs=(table_spec, P(DATA_AXIS, None), P(DATA_AXIS)),
            out_specs=P(DATA_AXIS, None, None),
        )
    )
    device_planes = {
        "fp": jax.device_put(planes["fp"],
                             NamedSharding(mesh, table_spec))
    }
    return step, device_planes
