"""Differential tests: jitted ops vs the scalar Java-semantics oracle."""
import random

import jax.numpy as jnp
import numpy as np
import pytest

import java_oracle as oracle
from kmergutsjava_tpu.constants import K
from kmergutsjava_tpu.ops.encode import aa_offsets, dna_codes, revcomp_codes
from kmergutsjava_tpu.ops.kmerize import kmer_windows
from kmergutsjava_tpu.ops.translate import translate_6frames

DNA_CHARS = "acgtuACGTUmrwsykbdhvnMRWSYKBDHVNxX .-123"
AA_CHARS = "ACDEFGHIKLMNPQRSTVWY*Xacdefz .1"


def _ascii(s):
    return np.frombuffer(s.encode("latin-1"), dtype=np.uint8)


def test_aa_offsets_all_bytes():
    chars = "".join(chr(i) for i in range(32, 127))
    got = np.asarray(aa_offsets(jnp.asarray(_ascii(chars))))
    want = [oracle.to_aa_off(c) for c in chars]
    assert got.tolist() == want


def test_dna_codes_all_bytes():
    chars = "".join(chr(i) for i in range(32, 127))
    got = np.asarray(dna_codes(jnp.asarray(_ascii(chars))))
    want = [oracle.dna_char(c) for c in chars]
    assert got.tolist() == want


def test_revcomp_codes():
    rng = random.Random(1)
    for _ in range(20):
        s = "".join(rng.choice(DNA_CHARS) for _ in range(rng.randint(1, 60)))
        got = np.asarray(revcomp_codes(jnp.asarray(_ascii(s))))
        want = [oracle.dna_char(c) for c in oracle.rev_comp(s)]
        assert got.tolist() == want


@pytest.mark.parametrize("length", list(range(0, 30)) + [97, 300])
def test_prepare_dna_matches_oracle(length):
    rng = random.Random(length)
    seq = "".join(rng.choice(DNA_CHARS) for _ in range(length))
    _check_dna(seq)


def test_prepare_dna_random_heavy():
    rng = random.Random(7)
    for trial in range(15):
        length = rng.randint(24, 400)
        seq = "".join(rng.choice("acgtACGT" if trial % 2 else DNA_CHARS)
                      for _ in range(length))
        _check_dna(seq)


def _next_pow2(x):
    p = 1
    while p < x:
        p *= 2
    return p


def _check_dna(seq):
    want = oracle.prepare_query(seq, aa=False)
    length = len(seq)
    mpad = _next_pow2(max(length // 3 + 1, 16))
    padded = np.zeros(3 * mpad, dtype=np.uint8)
    padded[:length] = _ascii(seq)
    frames = translate_6frames(jnp.asarray(padded), jnp.int64(length))
    num_starts = max(length // 3 - K + 1, 0)
    values, valid = kmer_windows(frames, jnp.full((6,), num_starts, dtype=jnp.int64))
    values = np.asarray(values)
    valid = np.asarray(valid)
    for row in range(6):
        got = [(int(values[row, i]), i) for i in np.nonzero(valid[row])[0]]
        assert got == want[row], f"frame row {row} mismatch for seq {seq!r}"


@pytest.mark.parametrize("length", list(range(0, 20)) + [150])
def test_prepare_aa_matches_oracle(length):
    rng = random.Random(100 + length)
    seq = "".join(rng.choice(AA_CHARS) for _ in range(length))
    want = oracle.prepare_query(seq, aa=True)[0]
    lpad = _next_pow2(max(length, 16))
    padded = np.zeros(lpad, dtype=np.uint8)
    padded[:length] = _ascii(seq)
    offs = aa_offsets(jnp.asarray(padded[None, :]))
    values, valid = kmer_windows(offs, jnp.asarray([length - K], dtype=jnp.int64))
    got = [(int(values[0, i]), i) for i in np.nonzero(np.asarray(valid)[0])[0]]
    assert got == want


def test_aa_final_window_quirk():
    # a protein of exactly K+1 residues yields ONE window (i < len-K), the
    # final full window at i=1 is skipped (ref :912)
    seq = "ACDEFGHIK"  # length 9
    want = oracle.prepare_query(seq, aa=True)[0]
    assert len(want) == 1 and want[0][1] == 0
