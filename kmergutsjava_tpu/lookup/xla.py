"""Vectorized probe-window lookup (jitted XLA).

Vectorized reformulation of the reference's streaming merge-join (lookup,
KmerGutsJava.java:944-1034). Instead of
a sequential scan with an in-flight probe set, every query probes a window of
consecutive slots in parallel, two-pass:

- pass 1 (all queries, short window W1) against a 2-byte **fingerprint
  plane** (4x less bandwidth than the int64 k-mer plane): a fingerprint
  match before the first empty slot nominates a candidate slot, verified by
  a single full-value gather; an empty slot before any candidate is a
  definitive miss (a true match implies a fingerprint match). Empty slots
  own a reserved fingerprint, so the empty rule is exact (ref :1000-1001).
- pass 2 (unresolved only: fully-occupied windows or the ~W/2^16
  fingerprint collisions): full window P2 >= table max_probe; presence
  implies the value lies within max_probe slots of its home (first-free-slot
  insertion keeps every slot between home and placement occupied forever),
  so "any match in the window" is exact — no empty-slot logic needed.

The device returns only (found, resolved, window_offset:uint8) — hit
metadata (otu/avgFromEnd/fI/wt) is gathered host-side from the table's
host arrays, minimizing device->host transfer and HBM footprint (only the
fingerprint and k-mer planes live on device).

Equivalence to the reference for linear-probe-built tables follows from the
same occupancy invariant; differential tests against lookup/parity.py pin
it down.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import EMPTY_KMER, MAX_ENCODED
from ..formats.kmer_table import KmerTable
from .parity import LookupHits

FIRST_PASS_WINDOW = 16

# uint16 fingerprint plane: fp(value) = value % FP_MOD in [0, FP_MOD);
# FP_EMPTY is reserved for empty slots.
FP_MOD = 65535
FP_EMPTY = 65535


# sparse probe layouts (XlaLookup probe_impl; env KMER_PROBE_IMPL)
PROBE_IMPLS = ("auto", "rows1", "chunked", "rows", "flat")


def env_probe_impl() -> str:
    """The KMER_PROBE_IMPL override ("auto" when unset); raises ValueError
    on a name that is not in PROBE_IMPLS."""
    import os

    impl = os.environ.get("KMER_PROBE_IMPL", "auto")
    if impl not in PROBE_IMPLS:
        raise ValueError(f"KMER_PROBE_IMPL={impl!r}: expected one of "
                         f"{', '.join(PROBE_IMPLS)}")
    return impl


def _round_up_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _first_event(win, q_fp, rel, in_window, probe_window):
    """Shared first-event scan of a gathered window: the earliest slot that
    is either a fingerprint CANDIDATE (verify host-side) or EMPTY (probing
    stops — definitive miss if no candidate came first) decides the query.

    ONE masked min over key = rel*2 + (0 candidate | 1 empty) replaces a
    two-reduction has_cand/empty_any form: one reduction pass per probe.
    A slot cannot be both (q_fp < FP_MOD = FP_EMPTY), so the parity tie
    never happens.

    Returns (off_u8, state_u8): state 1 = candidate at ``off`` (bit 2 is
    NO LONGER set when an empty follows the candidate — every consumer
    routes failed verifications to the exact host pass regardless, and
    reads the empty bit only when no candidate exists), 2 = empty first
    (miss), 0 = fully-occupied window, no match (exact host pass).
    """
    big2 = jnp.int32(2 * probe_window)
    key = jnp.where((win == q_fp[:, None]) & in_window, rel * 2,
                    jnp.where((win == jnp.uint16(FP_EMPTY)) & in_window,
                              rel * 2 + 1, big2))
    fst = jnp.min(key, axis=-1)
    hit = fst < big2
    is_cand = hit & (jnp.bitwise_and(fst, jnp.int32(1)) == 0)
    off = jnp.where(is_cand,
                    jax.lax.shift_right_logical(fst, jnp.int32(1)), 0)
    state = (is_cand.astype(jnp.uint8)
             + jnp.uint8(2) * (hit & ~is_cand).astype(jnp.uint8))
    return off.astype(jnp.uint8), state


@partial(jax.jit, static_argnames=("probe_window",))
def probe_fingerprint_pass(
    tbl_fp: jax.Array,  # [S + P] uint16 fingerprint plane
    q_fp: jax.Array,  # [N] uint16 query fingerprints
    homes: jax.Array,  # [N] int32
    probe_window: int,
):
    """Fingerprint-only probe: nothing 64-bit touches the device. Returns
    the (off_u8, state_u8) first-event contract of ``_first_event``; the
    caller verifies candidates against the host-side k-mer array. Per
    query: 6 bytes up, 2 bytes down."""
    rel = jnp.arange(probe_window, dtype=jnp.int32)[None, :]
    idx = homes[:, None].astype(jnp.int32) + rel
    fp = tbl_fp[idx]  # [N, W] uint16 gather — the only wide memory touch
    return _first_event(fp, q_fp, rel, True, probe_window)


@partial(jax.jit, static_argnames=("probe_window",))
def probe_fingerprint_rows(
    tbl_fp2d: jax.Array,  # [R, 128] uint16 plane (row-major reshape, +1 row)
    q_fp: jax.Array,  # [N] uint16
    homes: jax.Array,  # [N] int32
    probe_window: int,
):
    """Row-gather fingerprint probe.

    Gathers whole 128-lane ROWS from a 2-D operand: a probe window of
    W <= 128 always lies within two consecutive rows, so gather rows
    home>>7 and home>>7 + 1, then select the window with pure lane
    arithmetic. Reads 512 B/query instead of 2W B, as two contiguous row
    loads. Same (off, state) contract as probe_fingerprint_pass.
    """
    assert probe_window <= 128
    r = jax.lax.shift_right_logical(homes, jnp.int32(7))
    o = (homes & jnp.int32(127)).astype(jnp.int32)
    row0 = jnp.take(tbl_fp2d, r, axis=0)  # [N, 128] vectorized row gather
    row1 = jnp.take(tbl_fp2d, r + 1, axis=0)
    win = jnp.concatenate([row0, row1], axis=1)  # [N, 256]
    rel = (jnp.arange(256, dtype=jnp.int32)[None, :] - o[:, None])
    in_window = (rel >= 0) & (rel < probe_window)
    return _first_event(win, q_fp, rel, in_window, probe_window)


@partial(jax.jit, static_argnames=("probe_window", "stride"))
def probe_fingerprint_rows1(
    tbl_fp2d: jax.Array,  # [R, L] overlapped plane: row r = fp[r*stride:+L]
    q_fp: jax.Array,  # [N] uint16
    homes: jax.Array,  # [N] int32
    probe_window: int,
    stride: int,
):
    """Single-row-gather fingerprint probe on an OVERLAPPED plane.

    The plain row layout needs two row gathers per query because a probe
    window can straddle a row boundary. Laying the plane out with
    overlapping rows — row r covers slots [r*stride, r*stride + L) with
    stride = L - probe_window, L the lane width — guarantees the whole
    window of any home lies inside ONE row (offset o = home - r*stride
    < stride, so o + probe_window <= L): one gather per query, for a
    storage factor of L/stride.

    Lane width L comes from the plane's shape; 128 is the default at
    every window size (KMER_PROBE_LANES overrides). Each query's window is
    one contiguous 256-byte row load. Same (off, state) contract as
    probe_fingerprint_pass.
    """
    lanes = tbl_fp2d.shape[1]
    assert 0 < stride <= lanes - probe_window
    r = homes // jnp.int32(stride)  # constant divisor: XLA strength-reduces
    o = (homes - r * jnp.int32(stride)).astype(jnp.int32)
    win = jnp.take(tbl_fp2d, r, axis=0)  # [N, L] one vectorized row gather
    rel = jnp.arange(lanes, dtype=jnp.int32)[None, :] - o[:, None]
    in_window = (rel >= 0) & (rel < probe_window)
    return _first_event(win, q_fp, rel, in_window, probe_window)


@partial(jax.jit, static_argnames=("probe_window",))
def probe_fingerprint_chunk_bins(
    tbl_fp3: jax.Array,  # [C, chunk_rows, 128] rows1 plane, chunk-reshaped
    qfp_b: jax.Array,  # [C, cap] uint16 query fingerprints, host-binned
    row_b: jax.Array,  # [C, cap] uint16 chunk-local row of each query
    off_b: jax.Array,  # [C, cap] uint8 in-row offset (home - row*stride)
    probe_window: int,
):
    """Chunk-local row-gather probe for large planes.

    The overlapped rows1 plane is reshaped into C chunks of
    ``chunk_rows`` rows (a window never straddles rows, hence never
    chunks) and a lax.scan visits each chunk, gathering that chunk's
    queries from the small [chunk_rows, 128] slice, so every gather's
    operand stays small and its rows local.

    Queries are routed to per-chunk capacity bins ON THE HOST
    (XlaLookup._bin_queries: a threaded native two-pass binner, or a
    uint8-key radix argsort + one record gather), overlapped with device
    work by the dispatch worker.

    Returns per-bin-cell (off, state) with the probe_fingerprint_pass
    contract; cells the host left empty return garbage the host never
    reads back.
    """
    rel_base = jnp.arange(128, dtype=jnp.int32)[None, :]

    def chunk_fn(carry, xs):
        pl_c, qf, rr, oo = xs
        win = jnp.take(pl_c, rr.astype(jnp.int32), axis=0)  # [cap, 128]
        rel = rel_base - oo.astype(jnp.int32)[:, None]
        in_w = (rel >= 0) & (rel < probe_window)
        off_c, st_c = _first_event(win, qf, rel, in_w, probe_window)
        return carry, (off_c, st_c)

    _, (off_o, state_o) = jax.lax.scan(
        chunk_fn, jnp.int32(0), (tbl_fp3, qfp_b, row_b, off_b))
    return off_o, state_o


@partial(jax.jit, static_argnames=("probe_window", "stride"))
def probe_fingerprint_rows1_sorted(
    tbl_fp2d: jax.Array,
    q_fp: jax.Array,
    homes: jax.Array,
    probe_window: int,
    stride: int,
):
    """Overlapped-row probe with a device-side home sort around the gather
    (coalesces HBM row reads); results scattered back to input order."""
    n = homes.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    homes_s, idx_s = jax.lax.sort_key_val(homes, idx)
    off_s, state_s = probe_fingerprint_rows1(tbl_fp2d, q_fp[idx_s], homes_s,
                                             probe_window, stride)
    off = jnp.zeros_like(off_s).at[idx_s].set(off_s)
    state = jnp.zeros_like(state_s).at[idx_s].set(state_s)
    return off, state


@partial(jax.jit, static_argnames=("probe_window",))
def probe_fingerprint_pass_sorted(
    tbl_fp: jax.Array,
    q_fp: jax.Array,
    homes: jax.Array,
    probe_window: int,
):
    """Fingerprint pass with a device-side home sort around the gather.

    Sorting queries by home turns the plane gather from random reads
    into near-sequential ones without burning feeder-thread CPU on a host
    argsort. Outputs are scattered back to the caller's order, so this is
    a drop-in replacement for probe_fingerprint_pass.
    """
    n = homes.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    homes_s, idx_s = jax.lax.sort_key_val(homes, idx)
    off_s, state_s = probe_fingerprint_pass(tbl_fp, q_fp[idx_s], homes_s,
                                            probe_window)
    off = jnp.zeros_like(off_s).at[idx_s].set(off_s)
    state = jnp.zeros_like(state_s).at[idx_s].set(state_s)
    return off, state


@partial(jax.jit, static_argnames=("probe_window",))
def probe_fingerprint_rows_sorted(
    tbl_fp2d: jax.Array,
    q_fp: jax.Array,
    homes: jax.Array,
    probe_window: int,
):
    """Row-gather probe with a device-side home sort around the gather
    (coalesces HBM row reads); results scattered back to input order."""
    n = homes.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    homes_s, idx_s = jax.lax.sort_key_val(homes, idx)
    off_s, state_s = probe_fingerprint_rows(tbl_fp2d, q_fp[idx_s], homes_s,
                                            probe_window)
    off = jnp.zeros_like(off_s).at[idx_s].set(off_s)
    state = jnp.zeros_like(state_s).at[idx_s].set(state_s)
    return off, state


@partial(jax.jit, static_argnames=("probe_window",))
def probe_first_pass(
    tbl_kmer: jax.Array,  # [S + P] int64, padded with EMPTY_KMER
    values: jax.Array,
    homes: jax.Array,
    probe_window: int,
):
    """Exact short-window probe on the int64 plane with empty-slot
    resolution. Returns (found, resolved, off_u8)."""
    idx = homes[:, None].astype(jnp.int32) + jnp.arange(probe_window, dtype=jnp.int32)
    tk = tbl_kmer[idx]
    match = tk == values[:, None]
    empty = tk > MAX_ENCODED
    match_any = jnp.any(match, axis=-1)
    empty_any = jnp.any(empty, axis=-1)
    first_match = jnp.argmax(match, axis=-1).astype(jnp.int32)
    first_empty = jnp.argmax(empty, axis=-1).astype(jnp.int32)
    found = match_any & (~empty_any | (first_match < first_empty))
    resolved = found | empty_any
    off = jnp.where(found, first_match, 0).astype(jnp.uint8)
    return found, resolved, off


@partial(jax.jit, static_argnames=("probe_window",))
def probe_full_window(
    tbl_kmer: jax.Array,
    values: jax.Array,
    homes: jax.Array,
    probe_window: int,
):
    """Full-window exact probe: any match within probe_window >= max_probe.
    Returns (found, off_u8)."""
    idx = homes[:, None].astype(jnp.int32) + jnp.arange(probe_window, dtype=jnp.int32)
    match = tbl_kmer[idx] == values[:, None]
    found = jnp.any(match, axis=-1)
    off = jnp.where(found, jnp.argmax(match, axis=-1), 0).astype(jnp.uint8)
    return found, off


class XlaLookup:
    """Stateful wrapper owning the device-resident probe planes.

    Fingerprint mode (default): only the uint16 fingerprint plane lives in
    HBM; candidate verification and the exact full-window second pass run
    host-side against the table's host arrays, so device traffic is 6 bytes
    up / 2 bytes down per query and chunks are dispatched asynchronously
    (uploads, probes, and downloads pipeline across chunks).

    int64 mode (use_fingerprint=False): the classic two-pass probe on the
    int64 plane, fully on device.
    """

    DEFAULT_CHUNK = 1 << 19  # per-dispatch queries

    def __init__(self, table: KmerTable, probe_window: Optional[int] = None,
                 chunk: Optional[int] = None, device=None,
                 first_pass_window: int = FIRST_PASS_WINDOW,
                 use_fingerprint: bool = True,
                 probe_impl: Optional[str] = None,
                 host_only: bool = False):
        """host_only=True skips every device allocation (no fingerprint
        plane in HBM, no uploads): for callers that only need the host
        pieces — host_kmer, _host_full_window, windows — e.g. the stream
        kernel's exact-fallback helper."""
        import os

        if table.max_probe is None:
            table.compute_max_probe()
        self.table = table
        self.num_sigs = table.num_sigs
        self.full_window = probe_window or max(8, _round_up_pow2(table.max_probe))
        if self.full_window > 256:
            raise ValueError("probe window > 256 unsupported (uint8 offsets); "
                             "rebuild the table at a lower load factor")
        self.w1 = min(self._adaptive_w1(table, first_pass_window),
                      self.full_window)
        if not host_only and self.num_sigs >= 1 << 31:
            # every device impl (and the native binners' C ABI) carries
            # homes as int32; past 2^31 slots the cast would wrap silently
            # (negative tile index -> out-of-bounds native write)
            raise ValueError(
                f"table has {self.num_sigs} slots >= 2^31: int32 home "
                f"indexing would overflow — rebuild the table with fewer "
                f"slots or use the parity backend")
        self.use_fingerprint = use_fingerprint
        p = max(self.full_window, self.w1)
        s = table.num_sigs
        # host-side padded k-mer plane (verification + host second pass)
        self.host_kmer = np.full(s + p, EMPTY_KMER, dtype=np.int64)
        self.host_kmer[:s] = table.slots["kmer"]
        if host_only:
            self.probe_impl = None
            self.lanes = None
            self.tbl_fp = None
            self.tbl_kmer = None
            self.chunk = chunk if chunk is not None else self.DEFAULT_CHUNK
            return
        put = partial(jax.device_put, device=device)
        # Pad the device fp plane up to a canonical size bucket so tables of
        # similar size share one compiled probe executable (XLA specializes
        # on operand shapes; every fresh plane length would otherwise
        # trigger a full recompile). Padding probes read FP_EMPTY = miss.
        # (>= s + 128 so the overlapped rows1 layout always has a full last
        # row to view into.)
        plane_len = max(_round_up_pow2(s + max(p, 128)), 1 << 20)
        fp = np.full(plane_len, FP_EMPTY, dtype=np.uint16)
        occ = table.occupied
        fp[:s][occ] = (table.slots["kmer"][occ] % FP_MOD).astype(np.uint16)
        # probe_impl "rows1" (default for small planes): ONE gather of a
        # whole 128-lane row per query from an OVERLAPPED plane (row r =
        # slots [r*stride, r*stride+128), stride = 128 - w1) — every window
        # fits in one row. "chunked" (forced only): the same overlapped
        # plane reshaped into ~4MB chunks, queries host-binned to their
        # home chunk and gathered chunk-locally by a lax.scan.
        # "rows": two-row gather of a plain [R, 128] plane (windows may
        # straddle rows) — the fallback when w1 or the overlap storage
        # factor is too big. "flat": classic [N, W] 1-D gather (w1 > 128).
        if probe_impl is None:
            probe_impl = env_probe_impl()
        elif probe_impl not in PROBE_IMPLS:
            raise ValueError(f"unknown probe impl {probe_impl!r}")
        if probe_impl == "auto":
            probe_impl = "rows1"
        lanes = 128
        if probe_impl in ("rows1", "chunked"):
            budget = int(os.environ.get("KMER_ROWS1_MAX_BYTES", 4 << 30))
            if probe_impl == "rows1":
                # lane width: 128 unless KMER_PROBE_LANES overrides
                lanes = int(os.environ.get("KMER_PROBE_LANES", 0)) or 128
                # A lanes override <= w1 leaves no probe stride (the
                # budget loop would divide by zero at lanes == w1); every
                # window must fit one row, which needs lanes >= 2*w1.
                while lanes < 128 and lanes < 2 * self.w1:
                    lanes *= 2
                while (lanes < 128 and
                       (plane_len * 2 * lanes) // (lanes - self.w1) > budget):
                    lanes *= 2
            stride = lanes - self.w1
            if 2 * self.w1 > lanes or (plane_len * 2 * lanes) // stride > budget:
                probe_impl = "rows"  # w1 > 64 or overlap too costly
        if self.w1 > 128 and probe_impl == "rows":
            probe_impl = "flat"
        if probe_impl in ("rows1", "chunked"):
            self.stride = lanes - self.w1
            self.lanes = lanes
            nrows = -(-(plane_len - lanes) // self.stride) + 1
            ext = (nrows - 1) * self.stride + lanes
            if ext > plane_len:
                fp = np.concatenate(
                    [fp, np.full(ext - plane_len, FP_EMPTY, np.uint16)])
            fp2d = np.ascontiguousarray(np.lib.stride_tricks.as_strided(
                fp, shape=(nrows, lanes), strides=(2 * self.stride, 2)))
            # chunk the plane only when forced: auto keeps rows1 at every
            # plane size (on an NVIDIA H100 80GB HBM3 at 700 W, rows1 was
            # not slower than chunked on an 83.3M-slot plane; CHANGES.md)
            # (<= 32768 rows: the bin wire format carries local rows as u16)
            self.chunk_rows = min(
                int(os.environ.get("KMER_CHUNK_ROWS", 16384)), 32768)
            occ_rows = (s - 1) // self.stride + 1  # rows homes can land in
            if probe_impl == "chunked":
                if occ_rows > self.chunk_rows:
                    probe_impl = "chunked"
                    # trim the pow2 plane padding: the scan visits every
                    # chunk, so empty padding chunks would be pure waste;
                    # round the chunk count to a multiple of 4 so similar
                    # tables still share executables
                    nc = -(-occ_rows // self.chunk_rows)
                    self.n_chunks = -(-nc // 4) * 4
                    total = self.n_chunks * self.chunk_rows
                    fp2d = fp2d[:min(occ_rows, len(fp2d))]
                    if total > len(fp2d):
                        fp2d = np.concatenate(
                            [fp2d, np.full((total - len(fp2d), 128),
                                           FP_EMPTY, np.uint16)])
                    self._occ_chunks = nc
                    fp2d = fp2d.reshape(self.n_chunks, self.chunk_rows, 128)
                else:
                    probe_impl = "rows1"  # plane smaller than one chunk
            self.tbl_fp = put(fp2d)
        elif probe_impl == "rows":
            fp2d = np.concatenate(
                [fp, np.full(128, FP_EMPTY, np.uint16)]).reshape(-1, 128)
            self.lanes = 128
            self.stride = 0  # plain rows: windows may straddle (two-row gather)
            self.tbl_fp = put(fp2d)
        else:
            self.lanes = None  # flat layout has no row geometry
            self.stride = 0
            self.tbl_fp = put(fp)
        self.probe_impl = probe_impl
        self.tbl_kmer = put(self.host_kmer) if not use_fingerprint else None
        self.chunk = chunk if chunk is not None else self.DEFAULT_CHUNK

    @staticmethod
    def _adaptive_w1(table: KmerTable, floor: int) -> int:
        """Pick the pass-1 window so that fully-occupied windows (which
        force the exact second pass) stay rare. Linear-probe clusters are
        heavy-tailed at high load factors: at 0.7 load ~20%+ of homes sit
        in runs of 16+ occupied slots, which would push a fifth of all
        queries to pass 2. Measured on (a sample of) the actual occupancy."""
        occ = table.occupied
        if len(occ) > 2_000_000:
            start = len(occ) // 3
            occ = occ[start: start + 1_000_000]
        occ = occ.astype(np.int32)
        c = np.concatenate([[0], np.cumsum(occ)])
        w = floor
        while w < 256:
            if len(c) <= w:
                break
            run = c[w:] - c[:-w]
            frac_full = float((run == w).mean())
            if frac_full <= 0.02:
                break
            w *= 2
        return w

    def _chunk_cap(self, n: int) -> int:
        """Per-chunk bin capacity for the chunked probe: mean + 8 sigma
        (Poisson-ish for hash-uniform homes) + slack, rounded to sublanes.
        Static per (bucketed n, table) — executables reuse. Sized on the
        chunks homes can actually land in (the tail chunk holding only
        FP_EMPTY pad rows receives no real queries)."""
        mean = n / self._occ_chunks
        cap = int(mean + 8 * mean ** 0.5 + 72)
        return min(-(-cap // 8) * 8, max(8, n))

    def _bin_queries(self, q_fp: np.ndarray, homes: np.ndarray, cap: int):
        """Host-side routing for the chunked probe: group queries by home
        chunk into [n_chunks, cap] padded bins. Native threaded two-pass
        (histogram + cursor scatter, utils/native.py bin_queries) when the
        toolchain built it, else a uint8-key radix argsort + one record
        pass (~16M queries/s single-thread on the dev VM) — bit-identical
        by construction (rank = input encounter order within the chunk),
        pinned by tests/test_lookup.py. Overflowed queries (rank >= cap,
        only under adversarial home skew) are left out of the bins and
        resolved by the exact host pass. Returns
        (qfp_b, row_b, off_b, chunk_of, rank_of) with the latter two in
        the caller's query order."""
        from ..utils.native import bin_queries_native

        n = len(homes)
        native = bin_queries_native(
            homes, q_fp, self.stride, self.chunk_rows, self.n_chunks, cap)
        if native is not None:
            return native
        span = self.stride * self.chunk_rows
        c = (homes // span).astype(np.int32)
        c8 = c.astype(np.uint8 if self.n_chunks <= 256 else np.uint16)
        order = np.argsort(c8, kind="stable")  # radix for small ints
        c_s = c8[order].astype(np.int64)
        homes_s = homes[order]
        counts = np.bincount(c_s, minlength=self.n_chunks)
        starts = np.zeros(self.n_chunks, np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        rank = np.arange(n, dtype=np.int64) - starts[c_s]
        r_s = homes_s // self.stride
        qfp_b = np.zeros((self.n_chunks, cap), np.uint16)
        row_b = np.zeros((self.n_chunks, cap), np.uint16)
        off_b = np.zeros((self.n_chunks, cap), np.uint8)
        if counts.max() <= cap:
            qfp_b[c_s, rank] = q_fp[order]
            row_b[c_s, rank] = r_s - c_s * self.chunk_rows
            off_b[c_s, rank] = homes_s - r_s * self.stride
        else:
            ok = rank < cap
            io_, jo = c_s[ok], rank[ok]
            qfp_b[io_, jo] = q_fp[order][ok]
            row_b[io_, jo] = (r_s - c_s * self.chunk_rows)[ok]
            off_b[io_, jo] = (homes_s - r_s * self.stride)[ok]
        rank_of = np.empty(n, np.int64)
        rank_of[order] = rank
        return qfp_b, row_b, off_b, c.astype(np.int64), rank_of

    def dispatch_probe(self, q_fp: np.ndarray, homes: np.ndarray,
                       device_sort: bool = False):
        """Start one device probe dispatch from host arrays; returns an
        opaque pending handle for resolve_probe. Owns the padding
        (power-of-two buckets so distinct sizes reuse executables) and,
        for the chunked impl, the host-side bin routing."""
        n = len(homes)
        if self.probe_impl == "chunked":
            nb = n if n == self.chunk else max(_round_up_pow2(n), 4096)
            cap = self._chunk_cap(nb)
            qfp_b, row_b, off_b, chunk_of, rank_of = self._bin_queries(
                q_fp, homes, cap)
            out = probe_fingerprint_chunk_bins(
                self.tbl_fp, jnp.asarray(qfp_b), jnp.asarray(row_b),
                jnp.asarray(off_b), self.w1)
            return ("bins", out, chunk_of, rank_of, cap, n)
        target = (self.chunk if n == self.chunk
                  else max(_round_up_pow2(n), 4096))
        if target > n:
            q_fp = np.pad(q_fp, (0, target - n))
            homes = np.pad(homes, (0, target - n))
        probe = self.probe_chunk_sorted if device_sort else self.probe_chunk
        out = probe(jnp.asarray(q_fp), jnp.asarray(homes))
        return ("plain", out, n)

    def resolve_probe(self, pending):
        """Fetch one dispatch_probe result -> (off, state) numpy arrays in
        the caller's query order (state 0 = unresolved -> exact host
        pass)."""
        if pending[0] == "bins":
            _, out, chunk_of, rank_of, cap, n = pending
            off_bh, st_bh = jax.device_get(out)
            ok = rank_of < cap
            if ok.all():
                off = off_bh[chunk_of, rank_of]
                state = st_bh[chunk_of, rank_of]
            else:
                rc = np.minimum(rank_of, cap - 1)
                off = np.where(ok, off_bh[chunk_of, rc], np.uint8(0))
                state = np.where(ok, st_bh[chunk_of, rc], np.uint8(0))
            return off, state
        _, out, n = pending
        o, st = jax.device_get(out)
        return o[:n], st[:n]

    def probe_chunk(self, q_fp: jax.Array, homes: jax.Array):
        """One device dispatch of the fingerprint pass (jit-compiled).
        Non-chunked impls only — the chunked impl routes through
        dispatch_probe/resolve_probe (host binning)."""
        if self.probe_impl == "rows1":
            return probe_fingerprint_rows1(self.tbl_fp, q_fp, homes, self.w1,
                                           self.stride)
        if self.probe_impl == "rows":
            return probe_fingerprint_rows(self.tbl_fp, q_fp, homes, self.w1)
        return probe_fingerprint_pass(self.tbl_fp, q_fp, homes, self.w1)

    def probe_chunk_sorted(self, q_fp: jax.Array, homes: jax.Array):
        """Fingerprint pass with an on-device home sort (HBM-bound planes;
        keeps the feeder thread free of the host argsort)."""
        if self.probe_impl == "rows1":
            return probe_fingerprint_rows1_sorted(self.tbl_fp, q_fp, homes,
                                                  self.w1, self.stride)
        if self.probe_impl == "rows":
            return probe_fingerprint_rows_sorted(self.tbl_fp, q_fp, homes,
                                                 self.w1)
        return probe_fingerprint_pass_sorted(self.tbl_fp, q_fp, homes,
                                             self.w1)

    def _table_cols(self):
        """Contiguous copies of the table value columns (the structured
        slot array strides at 24 bytes, which the C ABI can't take)."""
        cols = getattr(self, "_cols", None)
        if cols is None:
            t = self.table.slots
            cols = (np.ascontiguousarray(t["otu"]),
                    np.ascontiguousarray(t["avg_from_end"]),
                    np.ascontiguousarray(t["fi"]),
                    np.ascontiguousarray(t["wt"]))
            self._cols = cols
        return cols

    def _verify_emit(self, values, homes, off, state, cnt, pos,
                     want_values: bool):
        """Resolve one dispatch's (off, state) answer into compacted hit
        columns: fingerprint-candidate verification against the full
        k-mer values, the exact full-window pass for the unresolved tail
        (incl. bin-overflow queries), and hit compaction. This is the
        largest per-query host stage, so it gets the native
        slice-parallel treatment
        (native/scatter.cpp gather_resolve_slots + emit_hits); the numpy
        twin below is bit-identical (pinned by tests/test_lookup.py).

        Returns ((cnt, pos, otu, avg, fi, wt) compacted columns,
        matched values or None)."""
        from ..utils.native import load_scatter

        n = len(values)
        lib = load_scatter()
        if lib is not None and n:
            values = np.ascontiguousarray(values, np.int64)
            slots = np.empty(n, np.int64)
            k = int(lib.gather_resolve_slots(
                values, np.ascontiguousarray(homes, np.int32),
                np.ascontiguousarray(off, np.uint8),
                np.ascontiguousarray(state, np.uint8), n,
                self.host_kmer, len(self.host_kmer), self.full_window,
                slots))
            t_otu, t_avg, t_fi, t_wt = self._table_cols()
            o_cnt = np.empty(k, np.int64)
            o_pos = np.empty(k, np.int64)
            o_otu = np.empty(k, np.int32)
            o_avg = np.empty(k, np.int32)
            o_fi = np.empty(k, np.int32)
            o_wt = np.empty(k, np.float32)
            o_val = np.empty(k, np.int64)
            cnt = np.ascontiguousarray(
                np.broadcast_to(np.asarray(cnt, dtype=np.int64), (n,)))
            pos = np.ascontiguousarray(pos, np.int64)
            lib.emit_hits(values, cnt, pos, slots, n, t_otu, t_avg, t_fi,
                          t_wt, o_cnt, o_pos, o_otu, o_avg, o_fi, o_wt,
                          o_val)
            return ((o_cnt, o_pos, o_otu, o_avg, o_fi, o_wt),
                    o_val if want_values else None)
        off64 = off.astype(np.int64)
        has_cand = (state & 1) != 0
        empty_any = (state & 2) != 0
        found = np.zeros(n, dtype=bool)
        ci = np.nonzero(has_cand)[0]
        slots_c = homes[ci].astype(np.int64) + off64[ci]
        verified = self.host_kmer[slots_c] == values[ci]
        found[ci] = verified
        unresolved = np.zeros(n, dtype=bool)
        unresolved[ci] = ~verified
        unresolved[~has_cand & ~empty_any] = True
        todo = np.nonzero(unresolved)[0]
        if len(todo):
            f2, o2 = self._host_full_window(values, homes, todo)
            found[todo] = f2
            off64[todo] = o2
        mask = found
        slots = homes[mask].astype(np.int64) + off64[mask]
        t = self.table.slots
        cntb = np.broadcast_to(np.asarray(cnt, dtype=np.int64), (n,))
        piece = (cntb[mask].copy(), np.asarray(pos)[mask].astype(np.int64),
                 t["otu"][slots].copy(), t["avg_from_end"][slots].copy(),
                 t["fi"][slots].copy(), t["wt"][slots].copy())
        return piece, (values[mask].copy() if want_values else None)

    def _host_full_window(self, values, homes, todo):
        """Exact full-window probe on the host k-mer array (for unresolved
        queries). W flat gathers instead of one [N, W] advanced-index
        gather: the latter materializes N*W int64 temporaries."""
        idx = homes[todo].astype(np.int64)
        v = values[todo]
        found = np.zeros(len(idx), dtype=bool)
        off = np.zeros(len(idx), dtype=np.uint8)
        hk = self.host_kmer
        # reverse order + overwrite == first-match offset
        for l in range(self.full_window - 1, -1, -1):
            m = hk[idx + l] == v
            off[m] = l
            found |= m
        return found, np.where(found, off, 0)

    def lookup(self, values: np.ndarray, cnt_id: np.ndarray, pos: np.ndarray,
               progress=None, compute_kmers_found: bool = True) -> LookupHits:
        """Full host-level lookup: fingerprint probe on device (async across
        chunks), host verification, host second pass, hit compaction."""
        values = np.asarray(values, dtype=np.int64)
        n = len(values)
        if n == 0:
            z = np.zeros(0)
            return LookupHits.from_lists(z, z, z, z, z, z, 0)
        homes = (values % np.int64(self.num_sigs)).astype(np.int32)

        if self.use_fingerprint:
            q_fp = (values % FP_MOD).astype(np.uint16)
            # dispatch every chunk before reading any result: uploads,
            # probes, and D2H transfers overlap
            pending = []
            for start in range(0, n, self.chunk):
                end = min(start + self.chunk, n)
                pending.append((start, end, self.dispatch_probe(
                    q_fp[start:end], homes[start:end])))
            off = np.empty(n, dtype=np.uint8)
            state = np.empty(n, dtype=np.uint8)
            for start, end, p in pending:
                o, st = self.resolve_probe(p)
                off[start:end] = o
                state[start:end] = st
                if progress is not None:
                    progress.update(end, int((st & 1).sum()))
            # native-threaded verification + exact pass + compaction
            piece, mv = self._verify_emit(values, homes, off, state,
                                          cnt_id, pos,
                                          compute_kmers_found)
            return LookupHits(
                cnt_id=piece[0], pos=piece[1], otu=piece[2],
                avg_from_end=piece[3], fi=piece[4], wt=piece[5],
                kmers_found=(int(np.unique(mv).size)
                             if compute_kmers_found else -1))
        else:
            found = np.empty(n, dtype=bool)
            resolved = np.empty(n, dtype=bool)
            off = np.empty(n, dtype=np.uint8)
            for start in range(0, n, self.chunk):
                end = min(start + self.chunk, n)
                v, h = values[start:end], homes[start:end]
                pad = self.chunk - (end - start) if n > self.chunk else 0
                if pad:
                    v = np.pad(v, (0, pad))
                    h = np.pad(h, (0, pad))
                f, r, o = jax.device_get(probe_first_pass(
                    self.tbl_kmer, jnp.asarray(v), jnp.asarray(h), self.w1))
                sl = slice(0, end - start)
                found[start:end] = f[sl]
                resolved[start:end] = r[sl]
                off[start:end] = o[sl]
                if progress is not None:
                    progress.update(end, int(f[sl].sum()))
            unresolved = ~resolved

        # exact full-window second pass (host) for the rare unresolved
        todo = np.nonzero(unresolved)[0]
        if len(todo):
            f2, o2 = self._host_full_window(values, homes, todo)
            found[todo] = f2
            off[todo] = o2

        mask = found
        slots = homes[mask].astype(np.int64) + off[mask]
        t = self.table.slots
        return LookupHits(
            cnt_id=np.asarray(cnt_id)[mask].astype(np.int64),
            pos=np.asarray(pos)[mask].astype(np.int64),
            otu=t["otu"][slots],
            avg_from_end=t["avg_from_end"][slots],
            fi=t["fi"][slots],
            wt=t["wt"][slots],
            kmers_found=(int(np.unique(values[mask]).size)
                         if compute_kmers_found else -1),
        )


class StreamingLookup:
    """Overlap the prepare phase with device probing.

    The reference runs prepare -> lookup strictly sequentially (its lookup
    is one merge-join pass over a sorted stream, ref :776-803). The
    vectorized probe has no such ordering constraint, so the feeder can
    dispatch a probe chunk the moment enough query k-mers exist: FASTA
    parsing/encoding, host->device transfer, device probing, and host
    verification all pipeline. Only resolved HITS are retained per chunk,
    so memory is bounded by the hit count — no spill files needed
    regardless of input size.

    Duck-types the query store's ``add_batch`` so the prepare functions
    feed it directly.

    Threading layout (all queues bounded, so backpressure caps memory):
    the caller's thread only parses/encodes and hands raw chunks to a
    *dispatch* worker (home sort + pad + host->device transfer + probe
    call — the transfer blocks in C and releases the GIL); a *resolve*
    worker does device_get + host verification. FASTA IO, transfers,
    device probing, and verification therefore all overlap.
    """

    MAX_IN_FLIGHT = 4

    def __init__(self, lk: XlaLookup, sort_chunks: Optional[bool] = None,
                 compute_kmers_found: bool = False,
                 async_resolve: bool = True,
                 device_sort: Optional[bool] = None,
                 async_dispatch: Optional[bool] = None):
        import os

        self.lk = lk
        if sort_chunks is None:
            if os.environ.get("KMER_SORT_CHUNKS") in ("0", "1"):
                sort_chunks = os.environ["KMER_SORT_CHUNKS"] == "1"
            else:
                # chunk-local home sort coalesces the gathers of the
                # two-row layouts only: an overlapped rows1 window is one
                # contiguous row load whatever the order, and the chunked
                # probe bins its queries by chunk already
                sort_chunks = (lk.probe_impl not in ("rows1", "chunked")
                               and lk.num_sigs * 2 > 32 * 1024 * 1024)
        self.sort_chunks = sort_chunks
        if device_sort is None:
            device_sort = os.environ.get("KMER_DEVICE_SORT", "") == "1"
        # device_sort: do the home sort on-device inside the probe program
        # (lax.sort_key_val) instead of a feeder-thread argsort. Same
        # gather coalescing; frees host CPU, but host-side verification
        # loses its locality — see docs/performance.md for the trade.
        self.device_sort = device_sort and sort_chunks
        self.compute_kmers_found = compute_kmers_found
        self._buf: list = []
        self._count = 0
        self._pending: list = []
        self._pieces: list = []
        self._matched_values: list = []
        self.total_fed = 0
        # resolver thread: device_get + host verification run off the
        # feeder thread, so FASTA parsing/encoding overlaps them (numpy
        # releases the GIL for the heavy ops)
        self._worker = None
        self._queue = None
        self._worker_error = None
        self._dispatcher = None
        self._dq = None
        if async_resolve:
            import queue
            import threading

            self._queue = queue.Queue(maxsize=self.MAX_IN_FLIGHT)
            self._lock = threading.Lock()

            def drain():
                while True:
                    item = self._queue.get()
                    if item is None:
                        return
                    try:
                        self._resolve_item(item)
                    except BaseException as ex:  # surfaced at finish()
                        self._worker_error = ex
                        return

            self._worker = threading.Thread(target=drain, daemon=True)
            self._worker.start()
        if async_dispatch is None:
            env = os.environ.get("KMER_ASYNC_DISPATCH")
            async_dispatch = (env == "1" if env in ("0", "1")
                              else async_resolve)
        if async_dispatch and async_resolve:
            import queue
            import threading

            self._dq = queue.Queue(maxsize=2)

            def dispatch_drain():
                while True:
                    chunk = self._dq.get()
                    if chunk is None:
                        return
                    try:
                        self._dispatch_chunk(*chunk)
                    except BaseException as ex:  # surfaced at finish()
                        self._worker_error = ex
                        return

            self._dispatcher = threading.Thread(target=dispatch_drain,
                                                daemon=True)
            self._dispatcher.start()

    # --- store interface ---
    def add_batch(self, values: np.ndarray, cnt_id, pos: np.ndarray) -> None:
        n = len(values)
        if n == 0:
            return
        cnt = np.broadcast_to(np.asarray(cnt_id, dtype=np.int64), (n,))
        self._buf.append((np.asarray(values, dtype=np.int64), cnt,
                          np.asarray(pos, dtype=np.int64)))
        self._count += n
        self.total_fed += n
        while self._count >= self.lk.chunk:
            self._dispatch(self.lk.chunk)

    def _dispatch(self, k: int) -> None:
        chunk = self._take(k)
        if self._dq is not None:
            self._put_checked(self._dq, chunk)  # bounded = feeder backpressure
        else:
            self._dispatch_chunk(*chunk)

    def _put_checked(self, q, item) -> None:
        """Bounded put that can't deadlock on a dead consumer: re-check the
        shared worker error whenever the queue stays full."""
        import queue

        while True:
            if self._worker_error is not None:
                raise self._worker_error
            try:
                q.put(item, timeout=1.0)
                return
            except queue.Full:
                continue

    def _take(self, k: int):
        out_v, out_c, out_p = [], [], []
        got = 0
        while got < k and self._buf:
            v, c, p = self._buf[0]
            need = k - got
            if len(v) <= need:
                out_v.append(v)
                out_c.append(c)
                out_p.append(p)
                got += len(v)
                self._buf.pop(0)
            else:
                out_v.append(v[:need])
                out_c.append(c[:need])
                out_p.append(p[:need])
                self._buf[0] = (v[need:], c[need:], p[need:])
                got = k
        self._count -= got
        return (np.concatenate(out_v), np.concatenate(out_c),
                np.concatenate(out_p))

    def _dispatch_chunk(self, values, cnt, pos) -> None:
        homes = (values % np.int64(self.lk.num_sigs)).astype(np.int32)
        if self.sort_chunks and not self.device_sort and len(values) > 1:
            order = np.argsort(homes, kind="stable")
            values, cnt, pos, homes = (values[order], cnt[order], pos[order],
                                       homes[order])
        q_fp = (values % FP_MOD).astype(np.uint16)
        out = self.lk.dispatch_probe(q_fp, homes,
                                     device_sort=self.device_sort)
        item = (values, cnt, pos, homes, out)
        if self._queue is not None:
            self._put_checked(self._queue, item)  # dispatch backpressure
        else:
            self._pending.append(item)
            while len(self._pending) >= self.MAX_IN_FLIGHT:
                self._resolve_item(self._pending.pop(0))

    def _resolve_item(self, item) -> None:
        values, cnt, pos, homes, out = item
        off, state = self.lk.resolve_probe(out)
        # native-threaded verification + exact pass + compaction (the
        # host roofline's top stage — lookup/xla.py _verify_emit)
        piece, mv = self.lk._verify_emit(values, homes, off, state, cnt,
                                         pos, self.compute_kmers_found)
        self._pieces.append(piece)
        if self.compute_kmers_found:
            self._matched_values.append(mv)

    def partial_hits(self) -> LookupHits:
        """Hits resolved so far (for the reference's catch-and-continue
        behavior on lookup errors, ref :797-802)."""
        return self._assemble()

    def finish(self) -> LookupHits:
        if self._count:
            self._dispatch(self._count)
        if self._dq is not None:
            self._put_checked(self._dq, None)
            self._dispatcher.join()
            self._dispatcher = None
            self._dq = None
        if self._queue is not None:
            self._put_checked(self._queue, None)
            self._worker.join()
            self._worker = None
            self._queue = None
            if self._worker_error is not None:
                raise self._worker_error
        while self._pending:
            self._resolve_item(self._pending.pop(0))
        return self._assemble()

    def _assemble(self) -> LookupHits:
        if not self._pieces:
            z = np.zeros(0)
            return LookupHits.from_lists(z, z, z, z, z, z,
                                         0 if self.compute_kmers_found else -1)
        cols = [np.concatenate(c) for c in zip(*self._pieces)]
        kf = (int(np.unique(np.concatenate(self._matched_values)).size)
              if self.compute_kmers_found else -1)
        return LookupHits(cols[0].astype(np.int64), cols[1].astype(np.int64),
                          cols[2], cols[3], cols[4], cols[5], kf)
