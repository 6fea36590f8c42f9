"""Amino-acid 8-mer packing as a vectorized polynomial evaluation (jitted JAX).

Replaces the reference's per-window scalar loop (encodedKmer,
KmerGutsJava.java:274-292, driven by
addKmers :900-922) with shifted-slice arithmetic: value(start i) =
sum_k a[i+k] * 20^(7-k), validity = all 8 offsets < 20 AND i < num_starts.

``num_starts`` encodes the reference's window bound exactly:
- aa mode: the loop is ``i < len - K`` (ref :912), so num_starts = len - K —
  NOTE this skips the final full window of the protein, a reference quirk we
  reproduce;
- DNA mode: the translated buffer has len/3+1 entries, windows ``i < L - K``,
  which over our length-(len//3) frame rows is num_starts = len//3 - K + 1.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import K, POW20

# numpy (not jnp) at module scope: a device constant minted under one trace
# (lazy first import) would leak into every later trace (see ops/encode.py)
_POW20 = np.asarray(POW20)


@jax.jit
def kmer_windows(aa_off: jax.Array, num_starts: jax.Array):
    """Pack every window of K amino-acid offsets into base-20 values.

    Args:
      aa_off: [..., N] uint8 offsets (0..19 valid; >=20 invalid/terminator).
      num_starts: [...] int — number of window start positions per row.

    Returns:
      values: [..., N-K+1] int64 — packed value per window start (garbage
        where invalid).
      valid:  [..., N-K+1] bool — window is in range and fully valid.
    """
    n = aa_off.shape[-1]
    w = n - K + 1
    a32 = aa_off.astype(jnp.int64)
    values = jnp.zeros(aa_off.shape[:-1] + (w,), dtype=jnp.int64)
    ok = jnp.ones(aa_off.shape[:-1] + (w,), dtype=bool)
    for k in range(K):
        seg = a32[..., k: k + w]
        values = values + seg * int(_POW20[k])
        ok = ok & (seg < 20)
    starts = jnp.arange(w)
    in_range = starts < jnp.expand_dims(num_starts, -1)
    return values, ok & in_range


# Largest modulus the int32 modular accumulation handles with NO
# mid-accumulation reduction: partial sums are bounded by
# 8 * max_offset * (mod - 1), max_offset <= 21 (19 valid +
# invalid/terminator codes 20/21). Larger moduli insert a `% m` every
# few terms instead — still int32-only (see kmer_window_mods).
_MAX_OFF = 21
MAX_MOD32 = (2**31 - 1) // (K * _MAX_OFF)
# hard cap with per-run reduction (see kmer_window_mods)
MOD32_LIMIT = (2**31 - 1) // (_MAX_OFF + 1)


def kmer_window_mods(aa_off: jax.Array, num_starts: jax.Array,
                     mods: tuple):
    """Residues of every window's packed value, in PURE int32.

    Keeping the fused prepare free of 64-bit integer arithmetic halves
    the bytes of every intermediate and avoids multi-instruction 64-bit
    multiplies. The fingerprint-candidate probe protocol (round 3) only
    ever needs value % num_sigs (the home slot) and value % 65535 (the
    fingerprint), never the value itself, and each residue is computable
    without i64:

        value % m = (sum_k off[i+k] * (20^(K-1-k) mod m)) mod m

    For m <= MAX_MOD32 (~12.8M) every partial sum provably fits int32
    with no intermediate reduction; larger moduli reduce the accumulator
    (`% m`) after every safe run of terms, keeping the invariant
    acc < m + run * 21 * (m - 1) < 2^31 at every step — exact for any
    m up to (2^31 - 1) // 22 (~97.6M slots, beyond every production
    table; the engine's int32 slot encoding itself caps num_sigs first).

    Args:
      aa_off: [..., N] uint8 offsets (0..19 valid; >=20 invalid).
      num_starts: [...] int — number of window start positions per row.
      mods: static tuple of int moduli.

    Returns:
      (residues, valid): residues is a tuple of [..., N-K+1] int32 arrays
      aligned with ``mods`` (garbage where invalid); valid as in
      `kmer_windows`. Exactness vs the int64 path is pinned by
      tests/test_ops.py.
    """
    for m in mods:
        # after a reduction acc < m; one more term adds < 21 * m
        if m > MOD32_LIMIT:
            raise ValueError(f"modulus {m} too large for int32 modular "
                             "accumulation")
    n = aa_off.shape[-1]
    w = n - K + 1
    a32 = aa_off.astype(jnp.int32)
    accs = [jnp.zeros(aa_off.shape[:-1] + (w,), dtype=jnp.int32)
            for _ in mods]
    ok = jnp.ones(aa_off.shape[:-1] + (w,), dtype=bool)
    # max terms addable onto a reduced accumulator before the next
    # reduction: acc < m + run * 21 * (m-1) must stay < 2^31
    runs = [max((2**31 - 1 - m) // (_MAX_OFF * (m - 1) + 1), 1)
            if m > 1 else K for m in mods]
    since = [0] * len(mods)
    for k in range(K):
        seg = a32[..., k: k + w]
        for j, m in enumerate(mods):
            accs[j] = accs[j] + seg * jnp.int32(pow(20, K - 1 - k, m))
            since[j] += 1
            if k < K - 1 and since[j] >= runs[j]:
                accs[j] = accs[j] % jnp.int32(m)
                since[j] = 0
        ok = ok & (seg < 20)
    starts = jnp.arange(w, dtype=jnp.int32)
    in_range = starts < jnp.expand_dims(num_starts, -1).astype(jnp.int32)
    return (tuple(a % jnp.int32(m) for a, m in zip(accs, mods)),
            ok & in_range)
