"""Dense slot-major streaming probe (zero-gather), in plain XLA.

Replacement for the reference's sequential table scan
(KmerGutsJava.java:964-1026) for query sets dense relative to the table,
where one sequential pass over the fingerprint plane costs less than
per-query random gathers. The probe contains NO gather at all: the
query->slot indirection becomes a dense *scatter on the host front end*
plus *static shifts on the device*:

- queries are bucketed by home slot into a dense tile ``qfp[c, s]`` holding
  the fingerprint of the c-th query whose home is slot ``s`` (up to C
  channels per slot; the rare extras fall back to the exact path);
- the probe ``fp[home + l] == qfp`` becomes, for each window offset l, a
  *static shift* of the fingerprint plane compared against the whole
  query tile. W static shifts replace N dynamic gathers, and XLA fuses the
  shifts, compares, selects and the output packing into one elementwise
  loop over the streamed plane.

The probe emits one int32 per (4 channels, slot): the raw
first-fingerprint-match offset of each channel, packed bytewise (w if no
match). Stop-at-empty semantics involve no query data, so they are applied
host-side against a precomputed per-slot empty-distance plane.  Host-side
verification against the full k-mer values and the exact fallback for the
unresolved remainder are shared with the XLA backend (same semantics as
lookup/xla.py, pinned by the same differential tests against
lookup/parity.py).

Device traffic per plane pass: 2 (fp) + 2C (query tile) + C (packed
result) bytes per table slot, independent of the probe window and of the
query count.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.kmer_table import KmerTable
from .parity import LookupHits
from .xla import FP_EMPTY, FP_MOD, XlaLookup

# Plane layout shared with the native scatter/decode (native/scatter.cpp
# scatter_chunk, resolve_slots): the plane is cut into [ROWS, BLOCK] slot
# superblocks, each row carrying a HALO-slot copy of the next row's head so
# every probe window of a row lies inside it.
BLOCK = 2048  # table slots per block row
ROWS = 8      # block rows per superblock
HALO = 128    # probe-window halo per row; also the max supported window
CHANNELS = 4  # query channels per slot (home-collision capacity)


@functools.partial(jax.jit, static_argnames=("w", "channels"))
def stream_probe_blocks(fp_blocks, qfp_tiles, w, channels=CHANNELS):
    """First fingerprint-match offset of every (channel, slot) query.

    fp_blocks [nsuper, ROWS, BLOCK + HALO] uint16, qfp_tiles [nsuper, C,
    ROWS, BLOCK] uint16 -> [nsuper, C // 4, ROWS, BLOCK] int32, four
    channels' offsets packed bytewise (w where no slot of the window
    matches). Offsets are scanned in reverse with overwrite-on-match, so
    the surviving value is the first match: one compare and one select per
    (shift, channel).
    """
    block = qfp_tiles.shape[-1]
    first = [jnp.full(fp_blocks.shape[:-1] + (block,), w, jnp.int32)
             for _ in range(channels)]
    for l in reversed(range(w)):
        win = fp_blocks[..., l:l + block]  # static shift, no gather
        for c in range(channels):
            first[c] = jnp.where(win == qfp_tiles[:, c], jnp.int32(l),
                                 first[c])
    # w <= 64 < 256: each offset fits one byte, 4 channels per int32
    planes = []
    for p in range(channels // 4):
        acc = first[4 * p]
        for c4 in range(1, 4):
            acc = acc | (first[4 * p + c4] << jnp.int32(8 * c4))
        planes.append(acc)
    return jnp.stack(planes, axis=1)


class StreamLookup:
    """Merge-join-regime lookup: dense query tiles vs the streamed table.

    Same exact-result contract as XlaLookup (differentially tested against
    lookup/parity.py); intended for query sets dense relative to the table,
    where one sequential pass over the fingerprint plane costs less than
    per-query random gathers.
    """

    def __init__(self, table: KmerTable, probe_window: Optional[int] = None,
                 chunk: Optional[int] = None, device=None,
                 channels: int = CHANNELS, nsuper_multiple: int = 1,
                 window: Optional[int] = None):
        """``window``: slots the device scan covers per query (default:
        the table's max probe). Any window is exact — queries whose window
        is full and unmatched go to the exact host pass — so a shorter one
        only moves work to the host."""
        if channels % 4:
            raise ValueError("channels must be a multiple of 4 (bytewise "
                             "int32 packing)")
        self.channels = channels
        if table.max_probe is None:
            table.compute_max_probe()
        self.table = table
        self.num_sigs = table.num_sigs
        # byte-packed results carry a 6-bit offset: windows cap at 64.
        # Probe work is proportional to w (one shift-compare series per
        # window offset), and nothing requires a power of two — round to a
        # multiple of 8 instead (max_probe 17 -> 24 shifts, not 32)
        self.w = min(max(8, -(-(window or table.max_probe) // 8) * 8), 64)
        if table.max_probe > 64:
            raise ValueError(
                "max_probe exceeds the packed-offset budget (64); rebuild "
                "the table at a lower load factor or use the xla backend")
        # exact path: host verification plane + full-window fallback
        self._exact = XlaLookup(table, probe_window=probe_window, chunk=chunk,
                                host_only=True,
                                device=device)
        self._cols = None  # contiguous table columns, built on first decode

        s = table.num_sigs
        self.nsuper = -(-s // (ROWS * BLOCK))
        if nsuper_multiple > 1:  # shard-divisible superblock count
            self.nsuper = -(-self.nsuper // nsuper_multiple) * nsuper_multiple
        nblocks = self.nsuper * ROWS
        fp = np.full(nblocks * BLOCK + HALO, FP_EMPTY, dtype=np.uint16)
        occ = table.occupied
        fp[:s][occ] = (table.slots["kmer"][occ] % FP_MOD).astype(np.uint16)
        # Per-slot distance to the first empty slot at or after it, capped
        # at w — the probe's stop-at-empty semantics depend only on the
        # table, so they are precomputed here once and applied host-side;
        # the device probe is a pure candidate scan. (The padded tail is
        # all-empty, so every slot has a next empty.)
        L = len(fp)
        e_idx = np.where(fp == FP_EMPTY, np.arange(L, dtype=np.int64),
                         np.int64(2 * L))
        nxt = np.minimum.accumulate(e_idx[::-1])[::-1]
        self.fe_plane = np.minimum(nxt - np.arange(L, dtype=np.int64),
                                   self.w).astype(np.uint8)
        strides = np.lib.stride_tricks.as_strided(
            fp, shape=(nblocks, BLOCK + HALO), strides=(BLOCK * 2, 2))
        self.fp_blocks = self._place_plane(
            np.ascontiguousarray(strides).reshape(
                self.nsuper, ROWS, BLOCK + HALO), device)

    def _place_plane(self, fp_host: np.ndarray, device):
        return jax.device_put(fp_host, device)

    def _probe(self, qfp_tiles: np.ndarray):
        return stream_probe_blocks(self.fp_blocks, jnp.asarray(qfp_tiles),
                                   self.w, self.channels)

    def _scatter_dense(self, values: np.ndarray, tiles: Optional[np.ndarray]
                       = None, occ: Optional[np.ndarray] = None):
        """Bucket queries into the dense [nsuper, C, ROWS, BLOCK] tile.

        Returns (qfp_tiles, homes, flat, shift), all columns full query
        length: ``flat`` is the element index into the *flattened* probe
        output [nsuper, C//4, ROWS, BLOCK] and ``shift`` the bit shift of
        the query's packed byte, or shift = -1 where the query exceeded
        its home slot's C channels (decode routes those to the exact
        fallback). With ``tiles``/``occ`` given (the incremental streaming
        path), scatters into the caller's tile and advances the per-slot
        channel occupancy instead of starting fresh.
        """
        from ..utils.native import load_scatter
        lib = load_scatter()
        if lib is not None:
            return self._scatter_dense_native(lib, values, tiles, occ)
        return self._scatter_dense_numpy(values, tiles, occ)

    def _scatter_dense_numpy(self, values, tiles=None, occ=None):
        homes = (values % np.int64(self.num_sigs)).astype(np.int64)
        # Duplicate values share one tile cell: equal values have the same
        # home and fingerprint, so one probe answers every copy. Real
        # corpora repeat k-mers heavily — deduplication keeps duplicates
        # from exhausting a slot's C channels (which would dump them on
        # the host exact path).
        uniq, inv = np.unique(values, return_inverse=True)
        nu = len(uniq)
        h_u = uniq % np.int64(self.num_sigs)
        order = np.argsort(h_u, kind="stable")
        h_s = h_u[order]
        rank = np.arange(nu) - np.searchsorted(h_s, h_s)
        if occ is not None:
            rank = rank + occ[h_s]
            uh, counts = np.unique(h_s, return_counts=True)
            occ[uh] = np.minimum(occ[uh].astype(np.int64) + counts,
                                 255).astype(occ.dtype)
        ok = rank < self.channels
        blk = h_s[ok] // BLOCK
        sup = (blk // ROWS).astype(np.int64)
        row = (blk % ROWS).astype(np.int64)
        within = (h_s[ok] % BLOCK).astype(np.int64)
        rk = rank[ok]
        qfp_tiles = (np.zeros((self.nsuper, self.channels, ROWS, BLOCK),
                              dtype=np.uint16) if tiles is None else tiles)
        qfp_tiles[sup, rk, row, within] = (
            uniq[order[ok]] % np.int64(FP_MOD)).astype(np.uint16)
        # flat element index into the [nsuper, planes, ROWS, BLOCK] output
        planes = self.channels // 4
        flat = (((sup * planes + (rk >> 2)) * ROWS + row) * BLOCK + within)
        shift = (8 * (rk & 3)).astype(np.int32)
        # expand unique placements back to the original query indices
        placed_ids = order[ok]
        flat_u = np.zeros(nu, dtype=np.int64)
        shift_u = np.full(nu, -1, dtype=np.int32)
        flat_u[placed_ids], shift_u[placed_ids] = flat, shift
        return qfp_tiles, homes, flat_u[inv], shift_u[inv]

    def _scatter_dense_native(self, lib, values, tiles=None, occ=None):
        """C++ scatter (kmergutsjava_tpu/native/scatter.cpp): sequential
        place-and-dedup, one pass per chunk. Dedup is by (home, fingerprint) against the
        tile itself, so it is GLOBAL across streaming chunks with no
        auxiliary structure; the rare fp-collision cell shares are
        resolved exactly by _decode's value verification + fallback.
        Channel ranks follow encounter order rather than the numpy path's
        value order — a different (equally valid) overflow split; results
        are identical, pinned by tests/test_native_scatter.py."""
        n = len(values)
        qfp_tiles = (np.zeros((self.nsuper, self.channels, ROWS, BLOCK),
                              dtype=np.uint16) if tiles is None else tiles)
        if occ is None:
            occ = np.zeros(self.num_sigs, dtype=np.uint8)
        homes = np.empty(n, dtype=np.int64)
        flat = np.empty(n, dtype=np.int64)
        shift = np.empty(n, dtype=np.int32)
        lib.scatter_chunk(
            np.ascontiguousarray(values), n, self.num_sigs, self.channels,
            BLOCK, ROWS, np.int64(FP_MOD),
            qfp_tiles.reshape(-1), occ, homes, flat, shift)
        return qfp_tiles, homes, flat, shift

    def lookup(self, values: np.ndarray, cnt_id: np.ndarray, pos: np.ndarray,
               progress=None, compute_kmers_found: bool = True) -> LookupHits:
        values = np.ascontiguousarray(values, dtype=np.int64)
        n = len(values)
        if n == 0:
            z = np.zeros(0)
            return LookupHits.from_lists(z, z, z, z, z, z, 0)
        qfp_tiles, homes, flat, shift = self._scatter_dense(values)
        from ..parallel.multihost import fetch_global

        out = fetch_global(self._probe(qfp_tiles))
        cnt = np.ascontiguousarray(
            np.broadcast_to(np.asarray(cnt_id, dtype=np.int64), (n,)))
        pos = np.ascontiguousarray(pos, dtype=np.int64)
        return self._decode(out, [(values, cnt, pos, homes, flat, shift)],
                            n, progress, compute_kmers_found)

    def _table_columns(self):
        """Contiguous copies of the table value columns (the structured
        slot array strides at 24 bytes, which C can't take directly)."""
        if self._cols is None:
            t = self.table.slots
            self._cols = (np.ascontiguousarray(t["otu"]),
                          np.ascontiguousarray(t["avg_from_end"]),
                          np.ascontiguousarray(t["fi"]),
                          np.ascontiguousarray(t["wt"]))
        return self._cols

    def _decode(self, out, chunks, n_total: int, progress,
                compute_kmers_found: bool, want_values: bool = False):
        """Resolve probe output into hits: fingerprint-candidate
        verification against the full k-mer values, the exact full-window
        pass for unresolved + channel-overflow queries, and hit
        compaction. ``chunks`` is a list of full-length query column
        tuples (v, cnt, pos, homes, flat, shift). With ``want_values``
        returns (hits, hit_values) — the multi-pass front end merges
        kmers-found counts across passes from the values."""
        from ..utils.native import load_scatter
        lib = load_scatter()
        if lib is not None:
            return self._decode_native(lib, out, chunks, n_total, progress,
                                       compute_kmers_found, want_values)
        return self._decode_numpy(out, chunks, n_total, progress,
                                  compute_kmers_found, want_values)

    def _decode_native(self, lib, out, chunks, n_total: int, progress,
                       compute_kmers_found: bool, want_values: bool = False):
        """Two-pass native decode (kmergutsjava_tpu/native/scatter.cpp
        resolve_slots + emit_hits, both thread-parallel): the resolve pass
        returns the exact hit count, so the hit columns are allocated at
        final size — no capacity-n buffers, no shrinking copies. No
        intermediate masks/concats — the dominant cost of the
        numpy twin at metagenome scales (~20 full-size array passes)."""
        t_otu, t_avg, t_fi, t_wt = self._table_columns()
        hk = self._exact.host_kmer
        out_flat = np.ascontiguousarray(out.reshape(-1))
        slots = []
        k_total = 0
        for v, c, p, h, fl, sh in chunks:
            s = np.empty(len(v), dtype=np.int64)
            k_total += lib.resolve_slots(
                v, h, fl, sh, len(v), out_flat, self.fe_plane, hk,
                len(hk), self.w, self._exact.full_window, s)
            slots.append(s)
        o_cnt = np.empty(k_total, dtype=np.int64)
        o_pos = np.empty(k_total, dtype=np.int64)
        o_otu = np.empty(k_total, dtype=np.int32)
        o_avg = np.empty(k_total, dtype=np.int32)
        o_fi = np.empty(k_total, dtype=np.int32)
        o_wt = np.empty(k_total, dtype=np.float32)
        o_val = np.empty(k_total, dtype=np.int64)
        k = 0
        for (v, c, p, _, _, _), s in zip(chunks, slots):
            k += lib.emit_hits(
                v, c, p, s, len(v), t_otu, t_avg, t_fi, t_wt,
                o_cnt[k:], o_pos[k:], o_otu[k:], o_avg[k:], o_fi[k:],
                o_wt[k:], o_val[k:])
        if progress is not None:
            progress.update(n_total, k)
        hits = LookupHits(
            cnt_id=o_cnt, pos=o_pos, otu=o_otu, avg_from_end=o_avg,
            fi=o_fi, wt=o_wt,
            kmers_found=(int(np.unique(o_val).size)
                         if compute_kmers_found else -1),
        )
        return (hits, o_val) if want_values else hits

    def _decode_numpy(self, out, chunks, n_total: int, progress,
                      compute_kmers_found: bool, want_values: bool = False):
        cat = lambda k: (np.concatenate([ch[k] for ch in chunks])
                         if chunks else np.zeros(0, dtype=np.int64))
        av, ac, ap, ah, aflat, ashift = (cat(k) for k in range(6))
        sel = ashift >= 0
        pv, pc, pp, ph = av[sel], ac[sel], ap[sel], ah[sel]
        flat, shift = aflat[sel], ashift[sel]
        packed = out.reshape(-1)[flat] >> shift
        off = (packed & 0xFF).astype(np.int64)  # first fp-match offset, w if none
        fe = self.fe_plane[ph].astype(np.int64)
        # a candidate counts only strictly before the first empty slot;
        # off == w (no match) can't pass because fe <= w and equality with
        # a real match offset is impossible (a slot isn't both)
        has_cand = off < fe
        empty_any = fe < self.w
        host_kmer = self._exact.host_kmer
        cand_slot = np.minimum(ph + off, len(host_kmer) - 1)
        verified = has_cand & (host_kmer[cand_slot] == pv)
        unresolved = (~verified & has_cand) | (~has_cand & ~empty_any)
        over = ~sel
        tv = np.concatenate([pv[unresolved], av[over]])
        tc = np.concatenate([pc[unresolved], ac[over]])
        tp = np.concatenate([pp[unresolved], ap[over]])
        th = np.concatenate([ph[unresolved], ah[over]])
        if len(tv):
            # the fallback outcome depends only on the VALUE (home and
            # window contents derive from it); metagenome-coverage inputs
            # repeat values heavily, so probe each distinct value once
            uv, inv = np.unique(tv, return_inverse=True)
            fu, ou = self._exact._host_full_window(
                uv, (uv % np.int64(self.num_sigs)).astype(np.int32),
                np.arange(len(uv), dtype=np.int64))
            f2, o2 = fu[inv], ou[inv]
        else:
            f2 = np.zeros(0, dtype=bool)
            o2 = np.zeros(0, dtype=np.int64)
        slots = np.concatenate([
            cand_slot[verified],
            np.minimum(th[f2] + o2[f2], self.num_sigs - 1)])
        hit_v = np.concatenate([pv[verified], tv[f2]])
        t = self.table.slots
        if progress is not None:
            progress.update(n_total, len(slots))
        hits = LookupHits(
            cnt_id=np.concatenate([pc[verified], tc[f2]]).astype(np.int64),
            pos=np.concatenate([pp[verified], tp[f2]]).astype(np.int64),
            otu=t["otu"][slots].copy(),
            avg_from_end=t["avg_from_end"][slots].copy(),
            fi=t["fi"][slots].copy(), wt=t["wt"][slots].copy(),
            kmers_found=(int(np.unique(hit_v).size)
                         if compute_kmers_found else -1),
        )
        return (hits, hit_v) if want_values else hits


class StreamingStreamLookup:
    """Feed-as-you-parse front end for the stream probe.

    Duck-types the query store's ``add_batch`` (like xla.StreamingLookup)
    so the prepare phase scatters each chunk of query k-mers straight into
    the persistent dense tiles — a per-slot channel-occupancy counter
    carries collision ranks across chunks — and ``finish()`` runs ONE
    probe pass over the table. The buffering copy through the query store
    and its final full-size argsort disappear; decode bookkeeping is kept
    columnar per chunk and concatenated once.
    """

    def __init__(self, lk: StreamLookup,
                 compute_kmers_found: bool = False,
                 async_scatter: Optional[bool] = None,
                 flush_limit: Optional[int] = None):
        import os

        self.lk = lk
        self.compute_kmers_found = compute_kmers_found
        # Bounded-memory contract (the stream analog of the reference's
        # inputSizeLimit spill sort, ref :822-889): every flush_limit
        # queries, run one plane pass, decode, retain ONLY the hits, and
        # reset the tiles/occupancy. Each pass is exact on its own
        # queries; extra passes just re-stream the plane.
        self.flush_limit = flush_limit
        self.qfp_tiles = np.zeros((lk.nsuper, lk.channels, ROWS, BLOCK),
                                  dtype=np.uint16)
        self._occ = np.zeros(lk.num_sigs, dtype=np.uint8)
        self._chunks: list = []   # per chunk: (v, cnt, pos, homes, flat, shift)
        self._passes: list = []   # completed passes' LookupHits
        self._pass_values: list = []  # per pass: unique hit values (debug)
        self._pending = 0         # queries scattered but not yet flushed
        self._since_flush = 0     # feed-side trigger counter
        self.total_fed = 0
        # Scatter worker: the native scatter is a ctypes call (GIL
        # released), so one worker thread overlaps it with the caller's
        # FASTA parse/translate/encode. Single worker = chunks scatter in
        # feed order (the tile/occ mutation is sequential by design).
        # Multi-pass flushes (probe + decode + reset) run on the SAME
        # worker as queue items, so the feed keeps parsing while a pass
        # probes/decodes; all tile/chunk/pass state is worker-owned in
        # async mode and only read by the caller after the final join.
        self._queue = None
        self._worker = None
        self._worker_error: Optional[BaseException] = None
        if async_scatter is None:
            env = os.environ.get("KMER_ASYNC_SCATTER")
            async_scatter = env != "0"
        self._async = async_scatter
        if async_scatter:
            self._start_worker()

    _FLUSH = object()  # queue marker: run one bounded-memory pass

    def _start_worker(self) -> None:
        import queue
        import threading

        self._queue = queue.Queue(maxsize=4)

        def drain():
            while True:
                item = self._queue.get()
                if item is None:
                    return
                try:
                    if item is StreamingStreamLookup._FLUSH:
                        self._flush_now()
                    else:
                        self._scatter_chunk(*item)
                except BaseException as ex:  # surfaced at finish()
                    self._worker_error = ex
                    return

        self._worker = threading.Thread(target=drain, daemon=True)
        self._worker.start()

    def _scatter_chunk(self, values, cnt, pos) -> None:
        _, homes, flat, shift = self.lk._scatter_dense(
            values, tiles=self.qfp_tiles, occ=self._occ)
        self._chunks.append((values, cnt, pos, homes, flat, shift))
        self._pending += len(values)

    def _flush_now(self) -> None:
        """One bounded-memory pass over everything scattered so far: probe
        the tiles, decode, keep ONLY the hits, reset tiles/occupancy.
        Runs on the worker thread in async mode (the feed keeps going)."""
        if not self._pending:
            return
        from ..parallel.multihost import fetch_global

        out = fetch_global(self.lk._probe(self.qfp_tiles))
        if self.compute_kmers_found:
            hits, vals = self.lk._decode(out, self._chunks, self._pending,
                                         None, False, want_values=True)
            self._pass_values.append(np.unique(vals))
        else:
            hits = self.lk._decode(out, self._chunks, self._pending, None,
                                   False)
        self._passes.append(hits)
        self._chunks = []
        self._pending = 0
        self.qfp_tiles.fill(0)
        self._occ.fill(0)

    def _put_checked(self, item) -> None:
        """Bounded put that can't deadlock on a dead worker: re-check the
        worker error whenever the queue stays full."""
        import queue

        while True:
            if self._worker_error is not None:
                raise self._worker_error
            try:
                self._queue.put(item, timeout=1.0)
                return
            except queue.Full:
                continue

    def add_batch(self, values: np.ndarray, cnt_id, pos: np.ndarray) -> None:
        values = np.ascontiguousarray(values, dtype=np.int64)
        n = len(values)
        if n == 0:
            return
        cnt = np.ascontiguousarray(
            np.broadcast_to(np.asarray(cnt_id, dtype=np.int64), (n,)))
        pos = np.ascontiguousarray(pos, dtype=np.int64)
        self.total_fed += n
        self._since_flush += n
        if self._queue is not None:
            self._put_checked((values, cnt, pos))
        else:
            self._scatter_chunk(values, cnt, pos)
        if self.flush_limit and self._since_flush >= self.flush_limit:
            # enqueue the pass behind the pending chunks: the worker
            # probes/decodes while this thread keeps parsing and feeding
            self._since_flush = 0
            if self._queue is not None:
                self._put_checked(StreamingStreamLookup._FLUSH)
            else:
                self._flush_now()

    def _join_worker(self) -> None:
        if self._worker is not None:
            self._queue.put(None)
            self._worker.join()
            self._worker = None
            self._queue = None
            if self._worker_error is not None:
                raise self._worker_error

    def partial_hits(self) -> LookupHits:
        """Nothing is probed before finish(); an error mid-prepare has
        found no hits yet (the reference reports whatever was found,
        ref :797-802)."""
        z = np.zeros(0)
        return LookupHits.from_lists(z, z, z, z, z, z,
                                     0 if self.compute_kmers_found else -1)

    def finish(self, progress=None) -> LookupHits:
        self._join_worker()
        if not self._passes:
            if not self.total_fed:
                return self.partial_hits()
            from ..parallel.multihost import fetch_global

            out = fetch_global(self.lk._probe(self.qfp_tiles))
            return self.lk._decode(out, self._chunks, self._pending,
                                   progress, self.compute_kmers_found)
        # multi-pass: flush the tail, then merge the per-pass hits
        self._flush_now()
        passes = self._passes
        kf = (int(np.unique(np.concatenate(self._pass_values)).size)
              if self.compute_kmers_found else -1)
        merged = LookupHits(
            cnt_id=np.concatenate([p.cnt_id for p in passes]),
            pos=np.concatenate([p.pos for p in passes]),
            otu=np.concatenate([p.otu for p in passes]),
            avg_from_end=np.concatenate([p.avg_from_end for p in passes]),
            fi=np.concatenate([p.fi for p in passes]),
            wt=np.concatenate([p.wt for p in passes]),
            kmers_found=kf)
        if progress is not None:
            progress.update(self.total_fed, len(merged))
        return merged
