"""Core constants and lookup tables for the signature-k-mer engine.

Semantics mirror the reference engine's constant block
(KmerGutsJava.java:84-99) and its
character-classification helpers (:111-318), re-expressed as dense uint8
lookup tables so that every per-character branch in the reference becomes a
single vectorized gather.
"""
from __future__ import annotations

import numpy as np

# k-mer length (ref :85)
K = 8
# 20^7 (ref :86)
CORE = 20 ** 7
# 20^8 — one past the largest encodable k-mer value (ref :87).
# A table slot is "empty" iff its stored value is > MAX_ENCODED (ref :1000).
MAX_ENCODED = CORE * 20
# Sentinel we write into empty slots of tables we build ourselves.
# Any value > MAX_ENCODED works for the reference reader; we pick int64 max
# so the "hi" 32-bit plane gets a distinctive all-ones pattern.
EMPTY_KMER = np.int64(2 ** 62)

# Size of one table slot in bytes: int64 kmer + int32 otu + int32 avgFromEnd
# + int32 functionIndex + float32 functionWt (ref :995-999).
ENTRY_SIZE = 24
TABLE_VERSION = 1

MAX_HITS_PER_SEQ = 40000  # ref :98
OI_BUFSZ = 5  # top-N OTU counter size (ref :99)

# Codon -> amino acid, indexed by c1*16 + c2*4 + c3 with A=0,C=1,G=2,T=3
# (ref :88-93; TTT-major order comment is historical -- the table below is
# the exact 64-entry table from the reference).
GENETIC_CODE = np.frombuffer(
    b"KNKNTTTTRSRSIIMI"
    b"QHQHPPPPRRRRLLLL"
    b"EDEDAAAAGGGGVVVV"
    b"*Y*YSSSS*CWCLFLF",
    dtype=np.uint8,
).copy()

# The 20 amino acids in offset order (ref :94-96).
PROT_ALPHA = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8).copy()

INVALID_AA = 20  # any non-amino-acid char (ref :174)
TERMINATOR_AA = 21  # written one past the end of each translation (ref :341)
INVALID_DNA = 4  # any ambiguous/unknown base (ref :317)


def _build_aa_off_lut() -> np.ndarray:
    """ASCII byte -> amino-acid offset 0..19, or 20 if invalid.

    Mirrors toAminoAcidOff (ref :111-175): ONLY the uppercase 20 letters map;
    lowercase amino acids are invalid, matching the reference exactly.
    """
    lut = np.full(256, INVALID_AA, dtype=np.uint8)
    for off, ch in enumerate(PROT_ALPHA):
        lut[ch] = off
    return lut


def _build_dna_code_lut() -> np.ndarray:
    """ASCII byte -> base code A=0 C=1 G=2 T/U=3, else 4 (ref dnaChar :294-318)."""
    lut = np.full(256, INVALID_DNA, dtype=np.uint8)
    for chars, code in ((b"aA", 0), (b"cC", 1), (b"gG", 2), (b"tuTU", 3)):
        for ch in chars:
            lut[ch] = code
    return lut


def _build_compl_lut() -> np.ndarray:
    """ASCII byte -> IUPAC complement ASCII byte (ref compl :177-260).

    Unknown characters map to themselves; note the reference's deliberate
    asymmetry: lowercase 's' complements to uppercase 'S' (ref :218-221).
    """
    lut = np.arange(256, dtype=np.uint8)
    pairs = [
        (b"a", b"t"), (b"A", b"T"),
        (b"c", b"g"), (b"C", b"G"),
        (b"g", b"c"), (b"G", b"C"),
        (b"t", b"a"), (b"u", b"a"), (b"T", b"A"), (b"U", b"A"),
        (b"m", b"k"), (b"M", b"K"),
        (b"r", b"y"), (b"R", b"Y"),
        (b"w", b"w"), (b"W", b"W"),
        (b"s", b"S"), (b"S", b"S"),
        (b"y", b"r"), (b"Y", b"R"),
        (b"k", b"m"), (b"K", b"M"),
        (b"b", b"v"), (b"B", b"V"),
        (b"d", b"h"), (b"D", b"H"),
        (b"h", b"d"), (b"H", b"D"),
        (b"v", b"b"), (b"V", b"B"),
        (b"n", b"n"), (b"N", b"N"),
    ]
    for src, dst in pairs:
        lut[src[0]] = dst[0]
    return lut


AA_OFF_LUT = _build_aa_off_lut()
DNA_CODE_LUT = _build_dna_code_lut()
COMPL_LUT = _build_compl_lut()

# Composite: ASCII byte -> base code of its complement. Used by the reverse-
# complement path so the character round-trip in the reference (compl() then
# dnaChar(), ref :263-272 + :320-331) collapses to one gather.
COMPL_DNA_CODE_LUT = DNA_CODE_LUT[COMPL_LUT]

# Codon index -> amino-acid offset (composing GENETIC_CODE with toAminoAcidOff;
# '*' stop codons map to INVALID_AA=20 exactly as in the reference, since
# toAminoAcidOff('*') == 20).
CODON_AA_OFF = AA_OFF_LUT[GENETIC_CODE]

# Powers of 20 for big-endian base-20 packing of an 8-mer (ref encodedKmer
# :274-292): value = sum(offset[i] * 20^(K-1-i)).
POW20 = (20 ** np.arange(K - 1, -1, -1, dtype=np.int64))

# 32-bit split of a k-mer value for device code that avoids int64:
# value = hi * 2^KMER_LO_BITS + lo, hi < 2^15, lo < 2^20.
KMER_LO_BITS = 20
KMER_LO_MASK = (1 << KMER_LO_BITS) - 1
# Sentinel in the "hi" int32 plane marking an empty slot (real hi < 2^15).
EMPTY_HI = np.int32(2 ** 30)
