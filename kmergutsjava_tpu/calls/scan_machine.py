"""The gatherHits state machine as a jitted lax.scan (device-side calls).

Device formulation of the reference's sequential per-container loop
(gatherHits/processSetOfHits, KmerGutsJava.java:457-514, :385-455): the
per-hit control flow becomes a `lax.scan` with a bounded state vector,
vmapped over a batch of padded containers, so hit-run detection and
function voting run as one device dispatch ("scanned segment-reduce" in
the north-star phrasing).

Key observation making the state bounded: processSetOfHits needs only
aggregates of the current list — the count/weight/last-position of
currentFI hits (accumulated in arrival order, which IS list order), the
first list position, the last two hits, and the list length. The OTU
counter, however, folds the *oI values* of counted hits at call time,
which cannot be bounded in a scan state; instead the scan emits per-call
(list-start-step, counted-end-step) ranges plus per-step appended flags,
and the host reconstructs each call's counted-hit oI sequence exactly and
folds the move-to-front counter there (it is tiny: <= 5 entries/sequence).

At most one processSetOfHits fires per hit step (a gap-close that retains
a seed pair cannot be followed by a pair trigger in the same step), plus
one final flush modeled as a sentinel step — so `steps = max_hits + 1`
call slots suffice.

Semantics notes:
- weight accumulates in float32 in list order (state carries an f32);
- the MAX_HITS_PER_SEQ append cap and the order constraint (ref :490-494)
  are implemented; min_hits < 2 (the reference's crash configuration) is
  rejected by the caller.
"""
from __future__ import annotations

from functools import partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import K, MAX_HITS_PER_SEQ
from ..utils.javafmt import jformat
from .grouping import GroupingParams

# state indices
(S_LEN,        # list length
 S_FIRST,      # first list position (hits[0].from0InProt)
 S_LASTPOS,    # last appended position
 S_LASTFI,     # last appended fI
 S_LASTAVG,    # last appended avgOffFromEnd
 S_L2FI,       # second-to-last fI
 S_CURFI,      # currentFI
 S_CNT,        # count of currentFI hits in list
 S_LASTCUR,    # position of last currentFI hit
 S_LASTCURSTEP,  # step index of last currentFI hit
 S_STARTSTEP,  # step index of first list element
 S_L2POS, S_L2AVG, S_L2OI, S_L2STEP,   # second-to-last hit fields
 S_L1POS, S_L1AVG, S_L1OI, S_L1STEP,   # last hit fields
 ) = range(19)
STATE_INTS = 19


def _scan_container(pos, oi, avg, fi, wt, length, *, min_hits, min_weighted,
                    max_gap, order_constraint):
    """Scan one container (padded arrays of len L, true length `length`).

    Returns per-step outputs:
      appended  [L+1] bool
      call_emit [L+1] bool
      call_rec  [L+1, 7] int32: fi, start, end, count, start_step, end_step,
                 weight bits (f32 view)
    """
    lmax = pos.shape[0]

    def make_call(st, wcur):
        # CALL record from current state (emission threshold applied here)
        ok = (st[S_CNT] >= min_hits) & (wcur >= jnp.float32(min_weighted))
        rec = jnp.array([st[S_CURFI], st[S_FIRST], st[S_LASTCUR] + (K - 1),
                         st[S_CNT], st[S_STARTSTEP], st[S_LASTCURSTEP], 0],
                        dtype=jnp.int32)
        rec = rec.at[6].set(
            jax.lax.bitcast_convert_type(wcur, jnp.int32))
        return ok, rec

    def process(st, wcur, step):
        """processSetOfHits (ref :385-455): returns (emit, rec, st', wcur')."""
        emit, rec = make_call(st, wcur)
        retain = (st[S_L2FI] != st[S_CURFI]) & (st[S_L2FI] == st[S_LASTFI])

        def retained(st):
            st = st.at[S_CURFI].set(st[S_LASTFI])
            st = st.at[S_LEN].set(2)
            st = st.at[S_FIRST].set(st[S_L2POS])
            st = st.at[S_CNT].set(2)
            st = st.at[S_LASTCUR].set(st[S_L1POS])
            st = st.at[S_LASTCURSTEP].set(st[S_L1STEP])
            st = st.at[S_STARTSTEP].set(st[S_L2STEP])
            return st

        def cleared(st):
            st = st.at[S_LEN].set(0)
            st = st.at[S_CNT].set(0)
            return st

        st2 = jax.lax.cond(retain, retained, cleared, st)
        w2 = jnp.where(
            retain,
            # recomputed in list order from zero over the seed pair
            jnp.float32(jnp.float32(0) + _w(st, S_L2STEP)) + _w(st, S_L1STEP),
            jnp.float32(0))
        return emit, rec, st2, w2

    # weights must be re-readable by step index for the seed-pair recompute
    wt32 = wt.astype(jnp.float32)

    def _w(st, idx_slot):
        return wt32[jnp.clip(st[idx_slot], 0, lmax - 1)]

    def step_fn(carry, xs):
        st, wcur = carry
        step, p, o, a, f, w = xs
        is_hit = step < length
        is_flush = step == length

        # --- gap close (ref :477-484) ---
        gap = is_hit & (st[S_LEN] > 0) & (st[S_LASTPOS] + max_gap < p)
        close = gap & (st[S_LEN] >= min_hits)
        drop = gap & (st[S_LEN] < min_hits)
        emit1, rec1, st_c, w_c = process(st, wcur, step)
        st = jax.lax.cond(close, lambda _: st_c, lambda _: st, None)
        wcur = jnp.where(close, w_c, wcur)
        emit1 = emit1 & close
        st = jax.lax.cond(
            drop, lambda s: s.at[S_LEN].set(0).at[S_CNT].set(0),
            lambda s: s, st)
        wcur = jnp.where(drop, jnp.float32(0), wcur)

        # --- currentFI reset on empty (ref :486-488) ---
        st = jax.lax.cond(is_hit & (st[S_LEN] == 0),
                          lambda s: s.at[S_CURFI].set(f), lambda s: s, st)

        # --- order constraint (ref :490-494) ---
        collinear = (f == st[S_LASTFI]) & (
            jnp.abs((p - st[S_LASTPOS]) - (st[S_LASTAVG] - a)) <= 20)
        accept = is_hit & ((not order_constraint) | (st[S_LEN] == 0)
                           | collinear)

        # --- append (ref :496-502) ---
        can_append = accept & (st[S_LEN] < MAX_HITS_PER_SEQ - 2)

        def appended(st):
            st = st.at[S_FIRST].set(
                jnp.where(st[S_LEN] == 0, p, st[S_FIRST]))
            st = st.at[S_STARTSTEP].set(
                jnp.where(st[S_LEN] == 0, step, st[S_STARTSTEP]))
            st = st.at[S_LEN].set(st[S_LEN] + 1)
            st = st.at[S_L2FI].set(st[S_LASTFI])
            st = st.at[S_L2POS].set(st[S_L1POS])
            st = st.at[S_L2AVG].set(st[S_L1AVG])
            st = st.at[S_L2OI].set(st[S_L1OI])
            st = st.at[S_L2STEP].set(st[S_L1STEP])
            st = st.at[S_LASTFI].set(f)
            st = st.at[S_LASTPOS].set(p)
            st = st.at[S_LASTAVG].set(a)
            st = st.at[S_L1POS].set(p)
            st = st.at[S_L1AVG].set(a)
            st = st.at[S_L1OI].set(o)
            st = st.at[S_L1STEP].set(step)
            is_cur = f == st[S_CURFI]
            st = st.at[S_CNT].set(st[S_CNT] + is_cur.astype(jnp.int32))
            st = st.at[S_LASTCUR].set(jnp.where(is_cur, p, st[S_LASTCUR]))
            st = st.at[S_LASTCURSTEP].set(
                jnp.where(is_cur, step, st[S_LASTCURSTEP]))
            return st

        w_app = jnp.where(can_append & (f == st[S_CURFI]),
                          jnp.float32(wcur + w.astype(jnp.float32)), wcur)
        st = jax.lax.cond(can_append, appended, lambda s: s, st)
        wcur = w_app

        # --- pair trigger (ref :503-508); checked even when the append was
        # capped, exactly like the reference ---
        trigger = (accept & (st[S_LEN] > 1) & (st[S_CURFI] != f)
                   & (st[S_L2FI] == st[S_LASTFI]))
        emit2, rec2, st_t, w_t = process(st, wcur, step)
        st = jax.lax.cond(trigger, lambda _: st_t, lambda _: st, None)
        wcur = jnp.where(trigger, w_t, wcur)
        emit2 = emit2 & trigger

        # --- final flush at the sentinel step (ref :511-513) ---
        flush = is_flush & (st[S_LEN] >= min_hits)
        emit3, rec3, st_f, w_f = process(st, wcur, step)
        st = jax.lax.cond(flush, lambda _: st_f, lambda _: st, None)
        wcur = jnp.where(flush, w_f, wcur)
        emit3 = emit3 & flush

        emit = emit1 | emit2 | emit3
        rec = jnp.where(emit1[None], rec1,
                        jnp.where(emit2[None], rec2, rec3))
        return (st, wcur), (can_append, emit, rec)

    st0 = jnp.zeros(STATE_INTS, dtype=jnp.int32)
    steps = jnp.arange(lmax + 1, dtype=jnp.int32)
    pad = lambda x: jnp.concatenate([x, x[:1]])
    xs = (steps, pad(pos.astype(jnp.int32)), pad(oi.astype(jnp.int32)),
          pad(avg.astype(jnp.int32)), pad(fi.astype(jnp.int32)),
          pad(wt32))
    (_, _), (appended, emit, recs) = jax.lax.scan(
        step_fn, (st0, jnp.float32(0)), xs)
    return appended, emit, recs


@partial(jax.jit, static_argnames=("min_hits", "min_weighted", "max_gap",
                                   "order_constraint"))
def scan_containers(pos, oi, avg, fi, wt, lengths, *, min_hits, min_weighted,
                    max_gap, order_constraint):
    """vmapped scan over a [C, Lmax] padded batch of containers."""
    fn = partial(_scan_container, min_hits=min_hits,
                 min_weighted=min_weighted, max_gap=max_gap,
                 order_constraint=order_constraint)
    return jax.vmap(fn)(pos, oi, avg, fi, wt, lengths)


def gather_hits_scan_batch(containers: List[Tuple], functions: Sequence[str],
                           p: GroupingParams):
    """Run a batch of containers through the device scan.

    ``containers``: list of (pos, oi, avg, fi, wt) numpy arrays (sorted by
    position). Returns a list (per container) of (call_lines, otu_updates)
    where otu_updates is [(oi, inc), ...] in fold order; the caller applies
    them to its per-sequence counter with _otu_add_batch.
    """
    if p.debug or p.min_hits < 2:
        raise ValueError("scan machine supports non-debug, min_hits >= 2")
    # Length-bucketed dispatch: padding every container to the GLOBAL max
    # made the batch cost C * Lmax cells (measured ~80x the real hit count
    # on realistic skewed mixes — most containers are tiny, a few are
    # huge). Group containers by power-of-two length bucket and scan each
    # bucket separately: total padded cells <= 2x the true hits, and the
    # handful of distinct [*, bucket] shapes reuse compiled executables.
    if len(containers) > 1:
        lens = [len(x[0]) for x in containers]
        if max(lens) > 2 * max(min(lens), 1):
            buckets: dict = {}
            for i, n in enumerate(lens):
                b = 1
                while b < n:
                    b *= 2
                buckets.setdefault(b, []).append(i)
            out = [None] * len(containers)
            for b in sorted(buckets):
                idxs = buckets[b]
                sub = gather_hits_scan_batch([containers[i] for i in idxs],
                                             functions, p)
                for i, r in zip(idxs, sub):
                    out[i] = r
            return out
    # bound padded batch memory: split very large container batches
    MAX_CELLS = 32 * 1024 * 1024
    lmax_all = max((len(x[0]) for x in containers), default=0)
    if containers and len(containers) * max(lmax_all, 1) > MAX_CELLS:
        per = max(MAX_CELLS // max(lmax_all, 1), 1024)
        out = []
        for i in range(0, len(containers), per):
            out.extend(gather_hits_scan_batch(containers[i: i + per],
                                              functions, p))
        return out
    c = len(containers)
    lmax = max((len(x[0]) for x in containers), default=0)
    lmax = max(lmax, 1)
    # power-of-two padding on BOTH dims so distinct batches reuse compiled
    # executables: every fresh (container count, length) pair would
    # otherwise compile its own vmapped scan, and compiles dominate the
    # wall clock (seconds each vs milliseconds of scan). Padded rows have
    # length 0 — they emit nothing and are sliced off below.
    p2 = 1
    while p2 < lmax:
        p2 *= 2
    lmax = p2
    cp = 8
    while cp < c:
        cp *= 2
    P = np.zeros((cp, lmax), np.int32)
    O = np.zeros((cp, lmax), np.int32)
    A = np.zeros((cp, lmax), np.int32)
    F = np.zeros((cp, lmax), np.int32)
    W = np.zeros((cp, lmax), np.float32)
    L = np.zeros(cp, np.int32)
    for i, (pos, oi, avg, fi, wt) in enumerate(containers):
        n = len(pos)
        L[i] = n
        P[i, :n] = pos
        O[i, :n] = oi
        A[i, :n] = avg
        F[i, :n] = fi
        W[i, :n] = wt
    appended, emit, recs = jax.device_get(scan_containers(
        jnp.asarray(P), jnp.asarray(O), jnp.asarray(A), jnp.asarray(F),
        jnp.asarray(W), jnp.asarray(L), min_hits=p.min_hits,
        min_weighted=p.min_weighted_hits, max_gap=p.max_gap,
        order_constraint=p.order_constraint))

    results = []
    for i in range(c):
        lines = []
        updates = []
        for s in np.nonzero(emit[i])[0]:
            call_fi, start, end, count, sstep, estep, wbits = recs[i, s]
            weight = np.int32(wbits).view(np.float32)
            lines.append("CALL\t%d\t%d\t%d\t%d\t%s\t%s" % (
                start, end, count, call_fi, functions[call_fi],
                jformat(float(weight))))
            # counted hits: appended steps in [sstep, estep] with the call's
            # function index, in order (ref :411-439)
            rng = slice(int(sstep), int(estep) + 1)
            sel = np.nonzero(appended[i][rng]
                             & (F[i, rng.start: rng.stop] == call_fi))[0]
            ois = O[i, rng.start: rng.stop][sel]
            if len(ois):
                bounds = np.concatenate(
                    [[0], np.nonzero(np.diff(ois))[0] + 1, [len(ois)]])
                for x, y in zip(bounds[:-1], bounds[1:]):
                    updates.append((int(ois[x]), int(y - x)))
        results.append((lines, updates))
    return results
