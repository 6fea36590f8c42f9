"""Fused on-device prepare+lookup: the "spmd" engine backend.

Every other backend splits the reference's phases (ref
KmerGutsJava.java:776-803) between
host prepare and a device probe over a query-k-mer stream. This backend
instead ships raw ASCII sequence bytes to the device and runs encode,
(6-frame translation,) 8-mer packing, and the table probe as ONE jitted
SPMD program per batch over a (data, table) mesh
(parallel/annotate_step.py) — the framework's "training step" analog,
now reachable from the CLI (``--backend spmd``).

Sequences longer than LONG_AA / LONG_NT route through the
sequence-parallel windowed steps (parallel/seq_windows.py), so one long
contig or protein also spreads over the data axis.

Hits come back as (container, position, metadata) columns feeding the
standard grouping machine, so reports stay byte-identical to every other
backend (tests/test_spmd_backend.py). In debug mode the matched k-mer
values are recomputed host-side at the hit coordinates (same LUT math as
models/prepare.py) for the reference's "Kmers found" accounting.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..constants import (AA_OFF_LUT, CODON_AA_OFF, COMPL_DNA_CODE_LUT,
                         DNA_CODE_LUT, INVALID_AA, K, POW20)
from ..formats.kmer_table import KmerTable
from ..lookup.parity import LookupHits
from .prepare import Prepared, _next_pow2, _seq_to_ascii

LONG_AA = 8192    # proteins longer than this go through 7-aa-overlap windows
LONG_NT = 24576   # contigs longer than this go through 24-nt-overlap windows
WIN_AA = 4096
WIN_NT = 12288    # multiple of 3
MAX_CELLS = 1 << 22  # per-dispatch batch-cells bound (B x bucket)
MAX_IN_FLIGHT = 4


def _host_frames(a: np.ndarray) -> np.ndarray:
    """Numpy 6-frame translation of one contig (reference row order
    +0+1+2-0-1-2), used only for debug-mode hit-value recompute."""
    L = len(a)
    m0 = L // 3
    rows = np.full((6, m0 + K), INVALID_AA, np.uint8)
    for strand, codes in ((0, DNA_CODE_LUT[a].astype(np.int32)),
                          (1, COMPL_DNA_CODE_LUT[a][::-1].astype(np.int32))):
        for f in range(3):
            p = (L - f) // 3
            if p <= 0:
                continue
            c1 = codes[f: f + 3 * p: 3]
            c2 = codes[f + 1: f + 1 + 3 * p: 3]
            c3 = codes[f + 2: f + 2 + 3 * p: 3]
            ok = (c1 < 4) & (c2 < 4) & (c3 < 4)
            rows[strand * 3 + f, :p] = np.where(
                ok, CODON_AA_OFF[np.where(ok, c1 * 16 + c2 * 4 + c3, 0)],
                INVALID_AA)
    return rows


def _values_at(offs_rows: np.ndarray, cc: np.ndarray) -> np.ndarray:
    """Packed k-mer values at window starts ``cc`` of per-hit offset rows
    (offs_rows[i] is the aa-offset row the i-th hit indexes into)."""
    vals = np.zeros(len(cc), np.int64)
    for k in range(K):
        vals += offs_rows[np.arange(len(cc)), cc + k].astype(np.int64) \
            * int(POW20[k])
    return vals


def _values_in_row(row: np.ndarray, cc: np.ndarray) -> np.ndarray:
    """Packed k-mer values at window starts ``cc``, all within ONE
    aa-offset row (hits grouped by sequence/frame)."""
    vals = np.zeros(len(cc), np.int64)
    for k in range(K):
        vals += row[cc + k].astype(np.int64) * int(POW20[k])
    return vals


class SpmdProgram:
    """Cacheable device state for the fused pipeline: mesh, compiled SPMD
    steps, and the device-resident table planes. Shared across engine runs
    (a server reuses it per table, like the other backends' lookup cache) —
    per-run bookkeeping lives in SpmdAnnotator."""

    def __init__(self, table: KmerTable, cfg):
        import jax

        from ..parallel.annotate_step import (make_sharded_annotate_step,
                                              make_sharded_dna_step)
        from ..parallel.mesh import (DATA_AXIS, default_mesh_shape,
                                     make_mesh)

        if table.max_probe is None:
            table.compute_max_probe()
        pw = cfg.probe_window or max(8, table.max_probe)
        if pw > 128:
            raise ValueError("spmd backend requires probe_window <= 128; "
                             "rebuild the table at a lower load factor")
        self.table = table
        self.aa = bool(cfg.aa)
        shape = cfg.mesh_shape or default_mesh_shape(len(jax.devices()))
        self.mesh = make_mesh(*shape)
        self.n_data = self.mesh.shape[DATA_AXIS]
        self.pw = pw
        if cfg.aa:
            self.step, self.planes = make_sharded_annotate_step(
                self.mesh, table, pw)
        else:
            self.step, self.planes = make_sharded_dna_step(
                self.mesh, table, pw)
        self._wstep = None  # windowed DNA step (built on first long contig)
        self._win_nt = None

    def windowed_dna(self, win_nt: int):
        from ..parallel.seq_windows import make_windowed_dna_step

        if self._wstep is None or self._win_nt != win_nt:
            self._wstep = make_windowed_dna_step(self.mesh, self.table,
                                                 self.pw, win_nt)
            self._win_nt = win_nt
        return self._wstep


class SpmdAnnotator:
    """Host driver for the fused device pipeline (one engine run)."""

    def __init__(self, table: KmerTable, cfg,
                 program: Optional[SpmdProgram] = None,
                 batch_rows: int = 512, min_bucket: int = 256):
        self.prog = program if program is not None else SpmdProgram(table,
                                                                    cfg)
        self.table = table
        self.cfg = cfg
        self.mesh = self.prog.mesh
        self.n_data = self.prog.n_data
        self.step, self.planes = self.prog.step, self.prog.planes
        self.batch_rows = batch_rows
        self.min_bucket = min_bucket
        self._pending: dict = {}    # bucket -> [(cid_base, ascii)]
        self._inflight: list = []   # (bases, lens, mats, device_out)
        self._pieces: list = []     # decoded (cnt, pos, otu, avg, fi, wt)
        self._val_pieces: list = [] # debug: matched values per piece
        self.debug_values = bool(cfg.debug)

    # --- prepare phase: parse + batch + dispatch ---

    def consume(self, records) -> Prepared:
        prep = Prepared(frames=1 if self.cfg.aa else 6)
        long_limit = LONG_AA if self.cfg.aa else LONG_NT
        for rec in records:
            a = _seq_to_ascii(rec.seq)
            base = prep.add_record(rec.id, len(rec.seq))
            if len(a) > long_limit:
                self._dispatch_long(base, a)
                continue
            bucket = _next_pow2(max(len(a), self.min_bucket))
            q = self._pending.setdefault(bucket, [])
            q.append((base, a))
            if len(q) >= max(1, min(self.batch_rows, MAX_CELLS // bucket)):
                self._flush(bucket)
        for b in list(self._pending):
            self._flush(b)
        return prep

    def _flush(self, bucket: int) -> None:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import DATA_AXIS

        rows = self._pending.pop(bucket, [])
        if not rows:
            return
        b = -(-len(rows) // self.n_data) * self.n_data  # data-shard multiple
        mat = np.zeros((b, bucket), dtype=np.uint8)
        lens = np.zeros(b, dtype=np.int64)  # pad rows: length 0 = no starts
        bases = np.full(b, -1, dtype=np.int64)
        for r, (base, a) in enumerate(rows):
            mat[r, : len(a)] = a
            lens[r] = len(a)
            bases[r] = base
        out = self.step(
            self.planes["fp"],
            jax.device_put(mat, NamedSharding(self.mesh, P(DATA_AXIS, None))),
            jax.device_put(lens, NamedSharding(self.mesh, P(DATA_AXIS))))
        self._inflight.append((bases, lens, mat, out))
        while len(self._inflight) >= MAX_IN_FLIGHT:
            self._decode(self._inflight.pop(0))

    def _decode(self, item) -> None:
        from ..ops.hostvalues import aa_values_at, dna_values_at
        from ..parallel.multihost import fetch_global
        from ..parallel.sharded_lookup import gather_hit_metadata

        bases, lens, mat, out = item
        slotp = np.asarray(fetch_global(out))
        # the device answers are fingerprint CANDIDATES: recompute the
        # query values at the candidate coordinates (O(hits x K) gathers,
        # no host re-translation — ops/hostvalues.py), verify against the
        # table's kmer column, and resolve the rare collisions exactly
        # (parallel/sharded_lookup.verify_candidates)
        if self.cfg.aa:
            rr, cc = np.nonzero(slotp)
            cnt = bases[rr]
            idx = (rr, cc)
            vals = aa_values_at(mat, rr, cc)
        else:
            rr, gg, cc = np.nonzero(slotp)
            cnt = bases[rr] + gg
            idx = (rr, gg, cc)
            vals = dna_values_at(mat, lens, rr, gg, cc)
        found, otu, avg, fi, wt = gather_hit_metadata(
            self.table, slotp[idx], values=vals, probe_window=self.prog.pw)
        if not found.all():
            cnt, cc, vals = cnt[found], cc[found], vals[found]
            otu, avg, fi, wt = otu[found], avg[found], fi[found], wt[found]
        self._pieces.append((cnt, cc.astype(np.int64), otu, avg, fi, wt))
        if self.debug_values and len(cc):
            self._val_pieces.append(vals)

    def _dispatch_long(self, base: int, a: np.ndarray) -> None:
        """Sequence-parallel path for one long record (synchronous; long
        records are rare by definition of the threshold)."""
        from ..parallel.seq_windows import (windowed_contig_hits,
                                            windowed_protein_hits)

        if self.cfg.aa:
            pos, otu, avg, fi, wt = windowed_protein_hits(
                self.mesh, self.step, self.planes, self.table, a, WIN_AA,
                probe_window=self.prog.pw)
            cnt = np.full(len(pos), base, np.int64)
            if self.debug_values and len(pos):
                offs = AA_OFF_LUT[a]
                self._val_pieces.append(_values_at(
                    np.broadcast_to(offs, (len(pos), len(offs))), pos))
        else:
            wstep, wplanes = self.prog.windowed_dna(WIN_NT)
            g, pos, otu, avg, fi, wt = windowed_contig_hits(
                self.mesh, wstep, wplanes, self.table, a, WIN_NT,
                probe_window=self.prog.pw)
            cnt = base + g
            if self.debug_values and len(pos):
                frames = _host_frames(a)
                width = frames.shape[1]
                offs_rows = np.zeros((len(pos), width), np.uint8)
                for i, gi in enumerate(g):
                    offs_rows[i] = frames[gi]
                self._val_pieces.append(_values_at(offs_rows, pos))
        self._pieces.append((cnt, pos.astype(np.int64), otu, avg, fi, wt))

    # --- lookup phase: drain + assemble ---

    def finish(self) -> LookupHits:
        while self._inflight:
            self._decode(self._inflight.pop(0))
        return self._assemble()

    def partial_hits(self) -> LookupHits:
        """Hits decoded so far (reference catch-and-continue, ref :797-802)."""
        return self._assemble()

    def _assemble(self) -> LookupHits:
        if not self._pieces:
            z = np.zeros(0)
            return LookupHits.from_lists(z, z, z, z, z, z,
                                         0 if self.debug_values else -1)
        cols = [np.concatenate(c) for c in zip(*self._pieces)]
        kf = -1
        if self.debug_values:
            kf = (int(np.unique(np.concatenate(self._val_pieces)).size)
                  if self._val_pieces else 0)
        return LookupHits(cols[0].astype(np.int64), cols[1].astype(np.int64),
                          cols[2], cols[3], cols[4],
                          cols[5].astype(np.float32), kf)
