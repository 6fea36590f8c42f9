"""Character-level encoding ops (jitted JAX).

Every per-character switch statement in the reference
(KmerGutsJava.java:111-318) becomes a 256-entry byte LUT over uint8 ASCII
arrays, applied as a plain table gather — no branches, no dynamic shapes.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import AA_OFF_LUT, COMPL_DNA_CODE_LUT, DNA_CODE_LUT

# numpy (not jnp) at module scope: the first import of this module can
# happen inside a traced function, and a device constant minted under one
# trace leaks into every later trace that reuses the module.
_AA_OFF = np.asarray(AA_OFF_LUT)
_DNA_CODE = np.asarray(DNA_CODE_LUT)
_COMPL_DNA_CODE = np.asarray(COMPL_DNA_CODE_LUT)


def byte_lut(lut: np.ndarray, idx_i32: jax.Array, width: int = 256
             ) -> jax.Array:
    """Apply a small value LUT to integer codes in [0, width)."""
    return jnp.asarray(lut[:width])[idx_i32]


@jax.jit
def aa_offsets(ascii_u8: jax.Array) -> jax.Array:
    """ASCII bytes -> amino-acid offsets 0..19 (20 = invalid).

    Mirrors toAminoAcidOff (ref :111-175) applied per char (ref :1054-1058).
    """
    return byte_lut(_AA_OFF, ascii_u8.astype(jnp.int32))


@jax.jit
def dna_codes(ascii_u8: jax.Array) -> jax.Array:
    """ASCII bytes -> base codes A=0 C=1 G=2 T/U=3 (4 = invalid), ref dnaChar."""
    return byte_lut(_DNA_CODE, ascii_u8.astype(jnp.int32))


@partial(jax.jit, static_argnames=("axis",))
def revcomp_codes(ascii_u8: jax.Array, axis: int = -1) -> jax.Array:
    """Base codes of the reverse complement of an ASCII DNA array.

    Collapses the reference's revComp char round-trip (compl per char then
    reverse, ref :263-272, then dnaChar during translation :324-326) into one
    composite-LUT gather plus a flip. IUPAC ambiguity codes complement to
    non-ACGT letters and therefore stay invalid (4), matching the reference.
    """
    return jnp.flip(byte_lut(_COMPL_DNA_CODE, ascii_u8.astype(jnp.int32)),
                    axis=axis)
