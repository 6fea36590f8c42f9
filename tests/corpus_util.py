"""Shared E. coli parity-corpus fixture: data location + the deterministic
signature-table recipe used by the corpus tests AND the golden-fixture
generator (scripts/make_goldens.py) — one definition so the goldens always
describe exactly what the tests run.

The corpus files are VENDORED into tests/data (copied from the reference's
test/data, ref KmerGutsJavaServerTest.java:76-86) so the parity leg runs on
any checkout.
"""
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def corpus_path(name: str) -> str:
    p = os.path.join(HERE, "data", name)
    if not os.path.exists(p):
        raise FileNotFoundError(p)
    return p


def load_corpus(n_prot=None, genome_slice=None):
    """(proteins, contig) from the vendored corpus, optionally sized down."""
    from kmergutsjava_tpu.formats.fasta import read_fasta

    prots = list(read_fasta(corpus_path("Ecoli_K12_W3110.faa.gz")))[:n_prot]
    contig = next(iter(read_fasta(corpus_path("Ecoli_K12_W3110.fna.gz"))))
    if genome_slice:
        contig = contig._replace(seq=contig.seq[:genome_slice])
    return prots, contig


def build_corpus_data_dir(dest: str, prots) -> str:
    """The deterministic corpus signature table: every protein except each
    third contributes its 8-mers, function = index mod 97, otu = index mod
    20, load factor 0.7."""
    from kmergutsjava_tpu.formats.table_tools import (signatures_from_proteins,
                                                      write_data_dir)

    triples = [(p.seq, i % 97, i % 20) for i, p in enumerate(prots)
               if i % 3 != 2]
    funcs = [f"ecoli function {i}" for i in range(97)]
    write_data_dir(dest, signatures_from_proteins(triples), funcs,
                   load_factor=0.7)
    return dest
