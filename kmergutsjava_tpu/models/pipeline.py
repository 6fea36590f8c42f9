"""End-to-end annotation engine (the reference's run(), re-phased).

Three phases with wall-clock info lines, mirroring
KmerGutsJava.java:742-820:

1. prepare  — FASTA -> device-batched encode/translate/kmerize -> query store
2. lookup   — probe the signature table (parity | xla | stream | ... backend)
3. group    — sequential call state machine -> report text

Report text is bit-identical to the reference in non-debug mode; info lines
(temp dir, phase timings, progress) follow the reference's printInfoLine
routing (ref :891-898): into the report only when debug, to stdout only when
the report goes to a file.
"""
from __future__ import annotations

import sys
import time
import traceback
from typing import Dict, Optional, TextIO

import numpy as np

from ..calls.grouping import (GroupingParams, Report, process_aa_seq,
                              process_dna_seq)
from ..config import EngineConfig
from ..constants import ENTRY_SIZE
from ..formats.fasta import read_fasta
from ..formats.function_index import load_function_index
from ..formats.kmer_table import read_table, resolve_table_files
from ..lookup.parity import LookupHits, TableTruncatedError, lookup_stream
from ..lookup.store import QueryKmerStore
from ..lookup.xla import XlaLookup
from .prepare import Prepared, prepare_aa, prepare_dna


# Device-resident lookups are expensive to (re)build: a host->device plane
# transfer plus potentially a kernel compile. One-slot cache keyed by table
# file identity + lookup-shaping config, so servers and repeated runs reuse
# the warm state.
_LOOKUP_CACHE: Dict[tuple, object] = {}

# Backend-'auto' density crossover: the stream probe (one plane pass) is
# chosen over per-query gathers when the query count exceeds
# num_sigs / DENSITY_CROSSOVER. On one NVIDIA H100 80GB HBM3 (700 W), with
# an 83.3M-slot table and 50M read k-mers (0.6 per slot, the dense side
# of this switch), the stream backend took 9.1-9.2 s wall (lookup 2.7 s)
# and the xla backend 6.2-6.3 s wall (its probes overlap the prepare
# phase, lookup 0.2 s): the sparse path still won there, so the crossover
# lies at a higher density on this card. The value stands until it is
# re-fitted over a density sweep.
DENSITY_CROSSOVER = 2.5


def _replace_backend(cfg: EngineConfig, backend: str) -> EngineConfig:
    import dataclasses

    return dataclasses.replace(cfg, backend=backend)


def _auto_backend(table, query: Optional[str], cfg: EngineConfig) -> str:
    """Density heuristic for backend 'auto' (both candidates are exact, so
    a wrong guess only costs speed). The stream probe pays one plane pass
    (~channels*numSigs slot-channels) regardless of query count while the
    row-gather path pays per query; the switch is at
    numSigs / DENSITY_CROSSOVER queries. Query count is estimated
    from the input size upfront: ~1 query k-mer per FASTA byte in aa mode,
    ~2 per byte for DNA (6 frames of len/3 windows, two strands), ~3.5x
    for gzip. Unknown sizes (stdin / server streams) return None — the
    caller defers the choice to _DeferredAutoFeed, which decides from the
    ACTUAL query count mid-prepare. With an explicit --mesh, the sparse
    side routes instead (the multi-device sparse path); the dense side
    shards the stream probe.
    """
    import os

    dense, sparse = _auto_candidates(cfg)
    if query is None:
        return None
    try:
        size = os.path.getsize(query)
    except OSError:
        return None
    if query.endswith(".gz"):
        size *= 3.5
    est_queries = size * (1.0 if cfg.aa else 2.0)
    return dense if est_queries > table.num_sigs / DENSITY_CROSSOVER else sparse


def _auto_candidates(cfg: EngineConfig):
    return ("stream", "routed") if cfg.mesh_shape else ("stream", "xla")


class _DeferredAutoFeed:
    """Backend-'auto' front end for unknown-size inputs (stdin and server
    streams, where no upfront size estimate exists): buffers prepare
    chunks in RAM, and the moment the query count crosses the stream
    probe's density crossover (numSigs/DENSITY_CROSSOVER) upgrades itself
    in place to the stream backend's incremental scatter, draining the
    buffer. A run
    that stays below the threshold finishes on the sparse one-shot path
    instead — below the crossover the buffered queries are small by
    definition, so the buffering costs nothing either way."""

    def __init__(self, engine: "Engine", table, cfg: EngineConfig):
        self.engine, self.table, self.cfg = engine, table, cfg
        self.threshold = table.num_sigs / DENSITY_CROSSOVER
        self._chunks: list = []
        self.total_fed = 0
        self._stream = None
        self._stream_failed = False

    def add_batch(self, values: np.ndarray, cnt_id, pos: np.ndarray) -> None:
        if self._stream is not None:
            self._stream.add_batch(values, cnt_id, pos)
            return
        values = np.asarray(values, dtype=np.int64)
        n = len(values)
        if n == 0:
            return
        cnt = np.broadcast_to(np.asarray(cnt_id, dtype=np.int64), (n,))
        self._chunks.append((values.copy(), cnt.copy(),
                             np.asarray(pos, dtype=np.int64).copy()))
        self.total_fed += n
        if self.total_fed > self.threshold and not self._stream_failed:
            self._upgrade()

    def _upgrade(self) -> None:
        from ..lookup.stream import StreamingStreamLookup

        try:
            lk = self.engine._stream_lookup(self.table, self.cfg)
            s = StreamingStreamLookup(lk, compute_kmers_found=self.cfg.debug,
                                      flush_limit=self.cfg.input_size_limit)
        except ValueError:
            # e.g. max_probe beyond the packed-offset budget: stay on the
            # buffered path and finish sparse (still exact, just slower)
            self._stream_failed = True
            return
        for v, c, p in self._chunks:
            s.add_batch(v, c, p)
        self._chunks = []
        self._stream = s
        self.engine.config = _replace_backend(self.cfg, "stream")

    def partial_hits(self) -> LookupHits:
        if self._stream is not None:
            return self._stream.partial_hits()
        z = np.zeros(0)
        return LookupHits.from_lists(z, z, z, z, z, z,
                                     0 if self.cfg.debug else -1)

    def finish(self) -> LookupHits:
        if self._stream is not None:
            return self._stream.finish()
        from ..lookup.store import REC_DTYPE

        _, sparse = _auto_candidates(self.cfg)
        self.engine.config = _replace_backend(self.cfg, sparse)
        rec = np.zeros(self.total_fed, dtype=REC_DTYPE)
        at = 0
        for v, c, p in self._chunks:
            rec["value"][at:at + len(v)] = v
            rec["cnt"][at:at + len(v)] = c
            rec["pos"][at:at + len(v)] = p
            at += len(v)
        self._chunks = []
        return self.engine._lookup(self.table, rec)


def _table_ident(table_path: str):
    import os

    try:
        return (os.path.realpath(table_path), os.path.getmtime(table_path),
                os.path.getsize(table_path))
    except OSError:
        return (table_path, None, None)


_TABLE_CACHE: Dict[tuple, object] = {}


def _cached_read_table(table_path: str):
    """Single-slot host-table cache keyed by (realpath, mtime, size) — the
    server answers many requests and a checkpointed run processes many
    batches against one table; re-reading a multi-GB file per run would
    dominate both. Same identity contract as _cached_xla_lookup."""
    ident = _table_ident(table_path)
    tbl = _TABLE_CACHE.get(ident)
    if tbl is None:
        tbl = read_table(table_path)
        _TABLE_CACHE.clear()
        _TABLE_CACHE[ident] = tbl
    return tbl


def _cached_xla_lookup(table_path: str, table, cfg: EngineConfig) -> "XlaLookup":
    import os

    ident = _table_ident(table_path)
    # the probe-impl env knobs shape the cached device plane — key on them
    # so a knob change (tests force impls this way) can't serve a stale impl
    impl_env = tuple(os.environ.get(k) for k in (
        "KMER_PROBE_IMPL", "KMER_PROBE_LANES",
        "KMER_CHUNK_ROWS",
        "KMER_ROWS1_MAX_BYTES"))
    key = (ident, cfg.probe_window, cfg.lookup_chunk, cfg.mesh_shape,
           impl_env)
    lk = _LOOKUP_CACHE.get(key)
    if lk is None:
        lk = XlaLookup(table, probe_window=cfg.probe_window,
                       chunk=cfg.lookup_chunk)
        _LOOKUP_CACHE.clear()
        _LOOKUP_CACHE[key] = lk
    return lk


class Engine:
    def __init__(self, config: Optional[EngineConfig] = None):
        self.config = config or EngineConfig()
        self._report: Optional[Report] = None
        self._stdout = True
        self._table_path: Optional[str] = None

    def _info(self, message: str, report: Report, stdout: bool) -> None:
        # ref printInfoLine :891-898
        if self.config.debug:
            report.println(message)
        if not stdout:
            print(message)

    def _parity_fallback(self, name: str, ex: Exception, cfg: EngineConfig):
        """Shared degrade path when a device backend can't serve this table:
        warn, rebind the run to the exact parity scan, and hand back a
        bounded-RAM store as the prepare feed."""
        import warnings

        warnings.warn(f"{name} backend unavailable ({ex}); "
                      "falling back to the parity scan")
        store = QueryKmerStore(self._table.num_sigs, cfg.input_size_limit,
                               cfg.resolved_temp_dir())
        self.config = cfg = _replace_backend(cfg, "parity")
        return store, store, cfg

    def _progress(self, total: int):
        from ..utils.timing import ProgressReporter

        report, stdout = self._report, self._stdout
        if report is None or (not self.config.debug and stdout):
            return None
        return ProgressReporter(total,
                                lambda msg: self._info(msg, report, stdout))

    def run(self, data_dir: str, query: Optional[str], out_stream: TextIO,
            stdout: bool = False, query_stream: Optional[TextIO] = None) -> None:
        from ..utils.timing import maybe_profile

        # _run may resolve backend "auto" (or degrade to "parity") by
        # rebinding self.config; restore so a reused Engine (the server)
        # re-resolves per request
        orig_config = self.config
        try:
            with maybe_profile(self.config.profile_dir):
                self._run(data_dir, query, out_stream, stdout, query_stream)
        finally:
            self.config = orig_config

    def _run(self, data_dir: str, query: Optional[str], out_stream: TextIO,
             stdout: bool = False, query_stream: Optional[TextIO] = None) -> None:
        cfg = self.config
        report = Report(out_stream)
        self._report, self._stdout = report, stdout
        import os
        self._info("Temp. directory: " + os.path.realpath(cfg.resolved_temp_dir()),
                   report, stdout)
        table_path, func_path = resolve_table_files(data_dir)
        self._table_path = table_path
        functions = load_function_index(func_path)
        table = _cached_read_table(table_path)
        self._table = table
        deferred = None
        if cfg.backend == "auto":
            choice = _auto_backend(table, query, cfg)
            if choice is None and not table.truncated:
                # unknown input size: decide from the real query count
                # mid-prepare (upgrades itself to the stream scatter at
                # the density crossover)
                deferred = _DeferredAutoFeed(self, table, cfg)
            else:
                self.config = cfg = _replace_backend(
                    cfg, choice or _auto_candidates(cfg)[1])

        # --- phase 1: prepare (ref :776-795) ---
        # xla backend: the feeder streams k-mer batches straight into the
        # device probe (parse/transfer/probe/verify pipeline; only hits are
        # retained, so no spill is needed). Other backends buffer through
        # the bounded-RAM store.
        t1 = time.time()
        streaming = None
        store = None
        spmd = None
        if deferred is not None:
            streaming = feed = deferred
        elif cfg.backend == "spmd" and not table.truncated:
            # fused device pipeline: raw sequence bytes go to the device;
            # encode/translate/kmerize/probe run as one SPMD program per
            # batch (models/spmd.py) — no host query-k-mer stream at all
            from .spmd import SpmdAnnotator, SpmdProgram

            try:
                key = ("spmd", _table_ident(self._table_path),
                       cfg.mesh_shape, cfg.aa, cfg.probe_window)
                prog = _LOOKUP_CACHE.get(key)
                if prog is None:
                    prog = SpmdProgram(table, cfg)
                    _LOOKUP_CACHE.clear()
                    _LOOKUP_CACHE[key] = prog
                spmd = SpmdAnnotator(table, cfg, program=prog)
            except ValueError as ex:
                store, feed, cfg = self._parity_fallback("spmd", ex, cfg)
        elif cfg.backend == "xla" and not table.truncated:
            from ..lookup.xla import StreamingLookup

            try:
                lk = _cached_xla_lookup(self._table_path, table, cfg)
                streaming = StreamingLookup(lk, compute_kmers_found=cfg.debug,
                                            sort_chunks=cfg.sort_chunks,
                                            device_sort=cfg.device_sort)
                feed = streaming
            except ValueError as ex:
                # e.g. pathologically dense table (probe window > 256):
                # degrade to the exact streaming scan instead of failing
                store, feed, cfg = self._parity_fallback("xla", ex, cfg)
        elif cfg.backend == "stream" and not table.truncated:
            # the dense-regime probe's streaming front end: each prepare
            # chunk scatters straight into the persistent query tiles;
            # finish() runs one probe pass over the whole table
            from ..lookup.stream import StreamingStreamLookup

            try:
                # flush_limit = the reference's inputSizeLimit (ref :108):
                # bounded RAM via one plane pass per 20M queries
                streaming = StreamingStreamLookup(
                    self._stream_lookup(table, cfg),
                    compute_kmers_found=cfg.debug,
                    flush_limit=cfg.input_size_limit)
                feed = streaming
            except ValueError as ex:
                # e.g. max_probe beyond the packed-offset budget
                store, feed, cfg = self._parity_fallback("stream", ex, cfg)
        else:
            store = QueryKmerStore(table.num_sigs, cfg.input_size_limit,
                                   cfg.resolved_temp_dir())
            feed = store
        try:
            prep = None
            if spmd is not None:
                records = read_fasta(query if query is not None
                                     else query_stream)
                prep = spmd.consume(records)
            elif cfg.prepare_impl == "native":
                # fully-native fast path: bulk parse + feeder share one
                # buffer, no per-record Python (None = fall through)
                from .prepare import try_prepare_bulk

                prep = try_prepare_bulk(query, query_stream, feed, cfg.aa)
            if prep is None:
                records = read_fasta(query if query is not None
                                     else query_stream)
                if cfg.prepare_impl == "native":
                    from .prepare import (prepare_aa_native, prepare_aa_numpy,
                                          prepare_dna_native,
                                          prepare_dna_numpy)

                    prep = (prepare_aa_native(records, feed) if cfg.aa
                            else prepare_dna_native(records, feed))
                    if prep is None:  # no toolchain: numpy fallback
                        prep = (prepare_aa_numpy(records, feed) if cfg.aa
                                else prepare_dna_numpy(records, feed))
                elif cfg.prepare_impl == "numpy":
                    from .prepare import prepare_aa_numpy, prepare_dna_numpy

                    prep = (prepare_aa_numpy(records, feed) if cfg.aa
                            else prepare_dna_numpy(records, feed))
                elif cfg.aa:
                    prep = prepare_aa(records, feed,
                                      min_bucket=cfg.length_bucket_base)
                else:
                    prep = prepare_dna(records, feed)
            rec = (store.finalize(require_sorted=(cfg.backend == "parity"))
                   if store is not None else None)
        except Exception:
            if store is not None:
                store.close()
            raise
        self._info("Preparation time: %d ms." % int((time.time() - t1) * 1000),
                   report, stdout)

        # --- phase 2: lookup (ref :796-803) ---
        t2 = time.time()
        if cfg.debug:
            report.println("Kmer-table info: numSigs=%d, entrySize=%d, version=%d"
                           % (table.num_sigs, ENTRY_SIZE, table.version))
        hits: LookupHits
        try:
            if streaming is not None:
                hits = streaming.finish()
            elif spmd is not None:
                hits = spmd.finish()
            else:
                hits = self._lookup(table, rec)
        except TableTruncatedError as ex:
            # ref :797-802 — EOFException: partial results + "Error: null"
            traceback.print_exc(file=sys.stderr)
            self._info("Error: null", report, stdout)
            hits = ex.partial
        except Exception as ex:  # noqa: BLE001
            # the reference catches ANY lookup failure, reports it, and
            # still groups whatever hits were found (ref :797-802)
            traceback.print_exc(file=sys.stderr)
            self._info("Error: " + (str(ex) or "null"), report, stdout)
            if streaming is not None:
                hits = streaming.partial_hits()
            elif spmd is not None:
                hits = spmd.partial_hits()
            else:
                hits = LookupHits.from_lists([], [], [], [], [], [], 0)
        finally:
            if store is not None:
                store.close()
        self._info("Lookup time: %d ms." % int((time.time() - t2) * 1000),
                   report, stdout)
        if cfg.debug:
            report.println("Kmers found: %d (pos-count=%d)"
                           % (hits.kmers_found, len(hits)))

        # --- phase 3: group (ref :804-819) ---
        t3 = time.time()
        params = GroupingParams(
            min_hits=cfg.min_hits, min_weighted_hits=cfg.min_weighted_hits,
            max_gap=cfg.max_gap, order_constraint=cfg.order_constraint,
            debug=cfg.debug)
        if (not cfg.debug and cfg.min_hits >= 2
                and cfg.grouping_impl == "host"):
            # fully-native grouping phase: sort + state machine + report
            # text in three C calls, no per-sequence Python (falls through
            # to the general path when the library is unavailable)
            from ..calls.batch_native import try_native_report

            if try_native_report(prep, hits, functions, cfg.aa, report,
                                 params):
                self._info("Grouping time: %d ms."
                           % int((time.time() - t3) * 1000), report, stdout)
                return
        container_hits = self._bucket_hits(prep, hits, functions, params)
        if (cfg.grouping_impl == "scan" and not cfg.debug
                and cfg.min_hits >= 2):
            self._group_scan(prep, container_hits, functions, report, params)
        else:
            for query_id, seq_len in prep.id_len.items():
                if cfg.aa:
                    process_aa_seq(query_id, seq_len, container_hits,
                                   functions, report, params)
                else:
                    process_dna_seq(query_id, seq_len, container_hits,
                                    functions, report, params)
                report.flush()
        self._info("Grouping time: %d ms." % int((time.time() - t3) * 1000),
                   report, stdout)

    def _group_scan(self, prep, container_hits, functions, report, params):
        """Device-scan grouping: one vmapped lax.scan dispatch over all
        containers, then host text emission + per-sequence OTU folds."""
        from ..calls.grouping import _otu_add_batch, tabulate_otu_data
        from ..calls.scan_machine import gather_hits_scan_batch

        cfg = self.config
        BIG = 4096  # huge containers go to the host machine (padding cost)
        order = []  # container keys in output order
        batch = []
        big_keys = set()
        for query_id in prep.id_len:
            keys = ([(query_id, "+", 0)] if cfg.aa else
                    [(query_id, s, f) for s in ("+", "-") for f in range(3)])
            for key in keys:
                pos, otu, avg, fi, wt = container_hits[key][:5]
                if len(pos) > BIG:
                    big_keys.add(key)
                    continue
                batch.append((pos, otu, avg, fi, wt))
                order.append(key)
        results = gather_hits_scan_batch(batch, functions, params)
        by_key = dict(zip(order, results))
        for query_id, seq_len in prep.id_len.items():
            oi_counts = []
            if cfg.aa:
                report.println("PROTEIN-ID\t%s\t%d" % (query_id, seq_len))
                self._emit_scan_container(
                    (query_id, "+", 0), by_key, big_keys, container_hits,
                    functions, oi_counts, report, params)
            else:
                report.println("processing %s[%d]" % (query_id, seq_len))
                for strand in ("+", "-"):
                    for frame in range(3):
                        report.println("TRANSLATION\t%s\t%d\t%s\t%d"
                                       % (query_id, seq_len, strand, frame))
                        self._emit_scan_container(
                            (query_id, strand, frame), by_key, big_keys,
                            container_hits, functions, oi_counts, report,
                            params)
            tabulate_otu_data(query_id, seq_len, oi_counts, report)
            report.flush()

    @staticmethod
    def _emit_scan_container(key, by_key, big_keys, container_hits, functions,
                             oi_counts, report, params):
        from ..calls.grouping import _gather_dispatch, _otu_add_batch

        if key in big_keys:
            _gather_dispatch(container_hits[key], functions, oi_counts,
                             report, params)
            return
        lines, updates = by_key[key]
        for ln in lines:
            report.println(ln)
        for o, inc in updates:
            _otu_add_batch(oi_counts, o, inc)

    def _lookup(self, table, rec) -> LookupHits:
        cfg = self.config
        if table.truncated and cfg.backend != "parity":
            # only the streaming parity scan reproduces the reference's
            # EOF-mid-probe partial results (ref :797-802)
            import warnings

            warnings.warn("table file is truncated; using the parity backend "
                          "for reference-exact partial results")
            return lookup_stream(table, rec["value"], rec["cnt"], rec["pos"])
        if cfg.backend == "parity":
            return lookup_stream(table, rec["value"], rec["cnt"], rec["pos"])
        if cfg.backend == "xla":
            lk = _cached_xla_lookup(self._table_path, table, cfg)
            values, cnt, pos = rec["value"], rec["cnt"], rec["pos"]
            # Home-sorted probes coalesce the device gathers of the
            # two-row layouts; a rows1 window is one contiguous row load
            # whatever the order, so skip the host sort there.
            if (lk.probe_impl != "rows1"
                    and table.num_sigs * 2 > 32 * 1024 * 1024
                    and len(values) > 1):
                order = np.argsort(values % np.int64(table.num_sigs),
                                   kind="stable")
                values, cnt, pos = values[order], cnt[order], pos[order]
            return lk.lookup(values, cnt, pos,
                             progress=self._progress(len(rec)),
                             compute_kmers_found=cfg.debug)
        if cfg.backend == "stream":
            # dense-regime probe: the table is streamed once per batch,
            # queries scattered into slot-major channel tiles
            lk = self._stream_lookup(table, cfg)
            return lk.lookup(rec["value"], rec["cnt"], rec["pos"],
                             progress=self._progress(len(rec)),
                             compute_kmers_found=cfg.debug)
        if cfg.backend == "sharded":
            return self._sharded_lookup(table, rec)
        if cfg.backend == "replicated":
            from ..parallel.replicated_lookup import (ReplicatedLookup,
                                                      make_data_mesh)
            import jax

            n_dev = (cfg.mesh_shape[0] * cfg.mesh_shape[1]
                     if cfg.mesh_shape else len(jax.devices()))
            rl = ReplicatedLookup(table, make_data_mesh(n_dev))
            return rl.lookup(rec["value"], rec["cnt"], rec["pos"])
        if cfg.backend == "routed":
            from ..parallel.routed_lookup import RoutedLookup, make_routed_mesh
            import jax

            shards = (cfg.mesh_shape[0] * cfg.mesh_shape[1]
                      if cfg.mesh_shape else len(jax.devices()))
            key = ("routed", _table_ident(self._table_path), shards)
            rl = _LOOKUP_CACHE.get(key)
            if rl is None:
                rl = RoutedLookup(table, make_routed_mesh(shards),
                                  probe_window=max(16, table.max_probe or 16))
                _LOOKUP_CACHE.clear()
                _LOOKUP_CACHE[key] = rl
            return rl.lookup(rec["value"], rec["cnt"], rec["pos"])
        raise ValueError(f"unknown lookup backend: {cfg.backend}")

    def _stream_lookup(self, table, cfg):
        """Build (with a warm-state cache) the stream-probe lookup; with
        --mesh, plane + tiles shard by superblock range over the devices
        (the scatter already routed queries home, so zero collectives)."""
        import os

        try:
            ident = (os.path.realpath(self._table_path),
                     os.path.getmtime(self._table_path),
                     os.path.getsize(self._table_path))
        except (OSError, TypeError):
            ident = (self._table_path, None, None)
        key = ("stream", ident, cfg.probe_window, cfg.lookup_chunk,
               cfg.mesh_shape)
        lk = _LOOKUP_CACHE.get(key)
        if lk is None:
            if cfg.mesh_shape:
                from ..parallel.stream_shards import (StreamShardedLookup,
                                                      make_stream_mesh)
                n = cfg.mesh_shape[0] * cfg.mesh_shape[1]
                lk = StreamShardedLookup(table, mesh=make_stream_mesh(n),
                                         probe_window=cfg.probe_window,
                                         chunk=cfg.lookup_chunk)
            else:
                from ..lookup.stream import StreamLookup
                lk = StreamLookup(table, probe_window=cfg.probe_window,
                                        chunk=cfg.lookup_chunk)
            _LOOKUP_CACHE.clear()
            _LOOKUP_CACHE[key] = lk
        return lk

    def _sharded_lookup(self, table, rec) -> LookupHits:
        """Multi-device lookup over a (data, table) mesh; mesh shape from
        config.mesh_shape or all available devices."""
        import jax

        from ..parallel.mesh import default_mesh_shape, make_mesh
        from ..parallel.sharded_lookup import (make_sharded_lookup,
                                               sharded_lookup_queries)

        cfg = self.config
        shape = cfg.mesh_shape or default_mesh_shape(len(jax.devices()))
        probe_window = cfg.probe_window or max(8, table.max_probe)
        key = ("sharded", _table_ident(self._table_path), shape, probe_window)
        cached = _LOOKUP_CACHE.get(key)
        if cached is None:
            mesh = make_mesh(*shape)
            cached = (mesh,) + make_sharded_lookup(mesh, table, probe_window)
            _LOOKUP_CACHE.clear()
            _LOOKUP_CACHE[key] = cached
        mesh, step, planes = cached
        values = np.asarray(rec["value"], dtype=np.int64)
        found, otu, avg, fi, wt = sharded_lookup_queries(
            mesh, step, planes, values, table, pad_multiple=256,
            probe_window=probe_window)
        mask = found.astype(bool)
        return LookupHits(
            cnt_id=np.asarray(rec["cnt"])[mask].astype(np.int64),
            pos=np.asarray(rec["pos"])[mask].astype(np.int64),
            otu=otu[mask], avg_from_end=avg[mask], fi=fi[mask],
            wt=wt[mask],
            kmers_found=(int(np.unique(values[mask]).size) if cfg.debug
                         else -1),
        )

    def _bucket_hits(self, prep: Prepared, hits: LookupHits, functions,
                     params) -> Dict[tuple, object]:
        """Distribute flat hit records into per-container lists.

        Mirrors the reference's container map semantics (ref :805-809): for
        duplicate (id, strand, frame) keys the LAST container wins, dropping
        hits of earlier same-key containers.
        """
        key_to_cnt = {}
        for cid, key in enumerate(prep.containers):
            key_to_cnt[key] = cid  # last wins
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int32),
                 np.zeros(0, np.int32), np.zeros(0, np.int32),
                 np.zeros(0, np.float32), True, True)
        by_container: Dict[tuple, tuple] = {k: empty for k in key_to_cnt}
        cnt_to_key = {cid: key for key, cid in key_to_cnt.items()}
        # one global (container, position) sort + segmented reductions: the
        # per-container sort and one-function check become O(1) lookups.
        # The stream path's fused decode emits hits in feed order, which IS
        # (container, position) order — detect that and skip the sort.
        c, p_ = hits.cnt_id, hits.pos
        presorted = len(c) == 0 or bool(np.all(
            (c[1:] > c[:-1]) | ((c[1:] == c[:-1]) & (p_[1:] >= p_[:-1]))))
        if presorted:
            cnt_s, pos_s, otu_s = hits.cnt_id, hits.pos, hits.otu
            avg_s, fi_s = hits.avg_from_end, hits.fi
            wt_s = hits.wt.astype(np.float32)
        else:
            order = np.lexsort((hits.pos, hits.cnt_id))
            cnt_s = hits.cnt_id[order]
            pos_s = hits.pos[order]
            otu_s = hits.otu[order]
            avg_s = hits.avg_from_end[order]
            fi_s = hits.fi[order]
            wt_s = hits.wt[order].astype(np.float32)
        from ..calls.batch_native import _sorted_unique
        uniq, starts = _sorted_unique(cnt_s)
        if len(starts):
            fi_min = np.minimum.reduceat(fi_s, starts)
            fi_max = np.maximum.reduceat(fi_s, starts)
            same_fi = fi_min == fi_max
        else:
            same_fi = np.zeros(0, dtype=bool)
        bounds = np.append(starts, len(cnt_s))
        counts = np.diff(bounds)

        cfg = self.config
        batch_ok = (not params.debug and params.min_hits >= 2
                    and cfg.grouping_impl == "host")
        from ..calls.batch_native import native_available
        use_native = batch_ok and native_available()
        pre = {}
        elig = np.zeros(len(prep.containers), dtype=bool)
        if use_native:
            # EVERY container becomes a precomputed ("pre", ...) result:
            # hitless ones are trivially empty (this alone removes one
            # python dispatch per container — ~300k for a 100k-read DNA
            # sweep), the rest run through the native machine below in
            # one ctypes call, and process_dna_seq's all-pre path then
            # emits each sequence as a single write
            empty_pre = ("pre", [], [])
            by_container = {k: empty_pre for k in key_to_cnt}
        elif batch_ok and not params.order_constraint and len(uniq):
            # no toolchain: batch-evaluate the single-function fast path
            # globally (the single-fi reduction proof needs no collinearity
            # filter, ref :490 can reject hits)
            from ..calls.batch_host import batch_single_fi_calls

            from ..constants import MAX_HITS_PER_SEQ as _CAP
            elig[uniq] = same_fi & (counts < _CAP - 2)
            pre = batch_single_fi_calls(cnt_s, pos_s, otu_s, fi_s, wt_s,
                                        elig, functions, params)
            empty_pre = ("pre", [], [])
            for key, cid in key_to_cnt.items():
                if elig[cid]:
                    by_container[key] = empty_pre

        native_pre = {}
        if use_native and len(uniq):
            from ..calls.batch_native import batch_group_calls

            todo = np.array([k for k, cid in enumerate(uniq.tolist())
                             if cnt_to_key.get(cid) is not None],
                            dtype=np.int64)
            native_pre = batch_group_calls(
                cnt_s, pos_s, otu_s, avg_s, fi_s, wt_s, todo, bounds,
                functions, params)

        bounds_l = bounds.tolist()
        for k, cid in enumerate(uniq.tolist()):
            key = cnt_to_key.get(cid)
            if key is None:
                continue  # superseded duplicate container
            if elig[cid]:
                lines, updates = pre.get(cid, ([], []))
                by_container[key] = ("pre", lines, updates)
                continue
            if cid in native_pre:
                by_container[key] = native_pre[cid]
                continue
            a, b = bounds_l[k], bounds_l[k + 1]
            by_container[key] = (pos_s[a:b], otu_s[a:b], avg_s[a:b],
                                 fi_s[a:b], wt_s[a:b], True, bool(same_fi[k]))
        return by_container
