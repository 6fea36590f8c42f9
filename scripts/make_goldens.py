#!/usr/bin/env python
"""Generate the checked-in golden parity reports (tests/data/golden_*.txt.gz).

Provenance (documented in docs/parity.md): this image has no JVM, so the
goldens cannot come from the reference Java binary.  They are produced by
the PARITY backend (lookup/parity.py — the line-by-line emulation of the
reference's forward-only merge-join) and accepted only if the xla and spmd
backends (independent device designs sharing no lookup/grouping code
path with it) reproduce them byte-identically.  They pin today's verified
behavior against regression; Java-agreement itself rests on the
transcription oracles (tests/java_oracle.py) and the quirk tests.

Usage: python scripts/make_goldens.py [--full]
"""
import gzip
import io
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

import jax

jax.config.update("jax_platforms", "cpu")

from corpus_util import build_corpus_data_dir, load_corpus  # noqa: E402

from kmergutsjava_tpu.config import EngineConfig  # noqa: E402
from kmergutsjava_tpu.models.pipeline import Engine  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "data")


def run(data_dir, fasta_text, backend, aa):
    out = io.StringIO()
    Engine(EngineConfig(backend=backend, aa=aa)).run(
        str(data_dir), None, out, stdout=True,
        query_stream=io.StringIO(fasta_text))
    return out.getvalue()


def make(tag, n_prot, genome_slice, backends=("parity", "xla", "spmd")):
    import tempfile

    prots, contig = load_corpus(n_prot, genome_slice)
    with tempfile.TemporaryDirectory() as d:
        build_corpus_data_dir(d, prots)
        fasta_aa = "".join(f">{p.id} {p.descr}\n{p.seq}\n" for p in prots)
        fasta_dna = f">{contig.id} {contig.descr}\n{contig.seq}\n"
        for mode, fasta, aa in (("aa", fasta_aa, True), ("dna", fasta_dna,
                                                         False)):
            ref = run(d, fasta, backends[0], aa)
            for b in backends[1:]:
                got = run(d, fasta, b, aa)
                assert got == ref, f"{tag}/{mode}: backend {b} diverges"
            path = os.path.join(OUT, f"golden_{mode}_{tag}.txt.gz")
            with open(path, "wb") as raw, gzip.GzipFile(
                    fileobj=raw, mode="wb", mtime=0) as fh:
                fh.write(ref.encode())
            print(f"wrote {path} ({len(ref)} chars, "
                  f"{ref.count(chr(10))} lines, backends agree: {backends})")


if __name__ == "__main__":
    make("800", 800, 300_000)
    if "--full" in sys.argv:
        make("full", None, None)
