"""Six-frame DNA translation as vectorized gathers (jitted JAX).

The reference translates one frame at a time with a scalar codon walk
(translate, KmerGutsJava.java:320-343)
into a reused buffer of length len/3+1, writing a terminator (offset 21) one
past the last codon. Here all 6 frames are produced in one shot as a
[6, Lpad//3] array of amino-acid offsets where every position at or past the
frame's codon count is 21 (invalid), which is provably hit-equivalent to the
reference's reused-buffer scheme: the reference's k-mer windows never read
past index len/3-1, and its stale-buffer positions always hold a terminator
there (see tests/test_translate.py for the property check).

Frame rows are ordered exactly as the reference creates hit containers
(prepareQuery, ref :1060-1073): +0, +1, +2, -0, -1, -2, with the '-' frames
translating the reverse complement from offset f.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import CODON_AA_OFF, INVALID_AA, INVALID_DNA, TERMINATOR_AA
from .encode import byte_lut, dna_codes, revcomp_codes

# numpy (not jnp) at module scope: the first import can happen inside a
# traced function (consumers import lazily), and a device constant minted
# under one trace leaks into every later trace that reuses the module.
_CODON_AA = np.asarray(CODON_AA_OFF)


def _frames_from_codes(codes: jax.Array, length: jax.Array) -> jax.Array:
    """codes [Lpad] (0..4, padding arbitrary) -> [3, Lpad//3] aa offsets."""
    lpad = codes.shape[-1]
    m = lpad // 3
    j = jnp.arange(m)
    frames = []
    for f in range(3):
        pos = f + 3 * j
        c1 = jnp.take(codes, pos, mode="fill", fill_value=INVALID_DNA)
        c2 = jnp.take(codes, pos + 1, mode="fill", fill_value=INVALID_DNA)
        c3 = jnp.take(codes, pos + 2, mode="fill", fill_value=INVALID_DNA)
        codon_ok = (c1 < 4) & (c2 < 4) & (c3 < 4)
        idx = (c1.astype(jnp.int32) * 16 + c2.astype(jnp.int32) * 4 + c3.astype(jnp.int32))
        # 64-entry codon LUT via encode.byte_lut
        aa = jnp.where(codon_ok,
                       byte_lut(_CODON_AA, jnp.where(codon_ok, idx, 0),
                                width=64),
                       INVALID_AA)
        # p = number of codons in this frame: floor((length - f) / 3), >= 0
        p = jnp.maximum(length - f, 0) // 3
        aa = jnp.where(j < p, aa, TERMINATOR_AA)
        frames.append(aa.astype(jnp.uint8))
    return jnp.stack(frames)


@jax.jit
def translate_6frames(ascii_u8: jax.Array, length: jax.Array) -> jax.Array:
    """ASCII DNA [Lpad] (valid content in [0, length)) -> [6, Lpad//3] offsets.

    Rows 0-2: '+' strand frames 0-2; rows 3-5: '-' strand frames 0-2.
    """
    codes = dna_codes(ascii_u8)
    rc = revcomp_codes(ascii_u8)
    # flip() put the (suffix) padding at the front; rotate the true sequence
    # back to offset 0 so frame offsets line up with the reference.
    rc = jnp.roll(rc, -(ascii_u8.shape[-1] - length))
    fwd = _frames_from_codes(codes, length)
    rev = _frames_from_codes(rc, length)
    return jnp.concatenate([fwd, rev], axis=0)
