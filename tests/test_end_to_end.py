"""End-to-end: fixture data dir -> CLI/engine -> report. Cross-backend
byte-identity plus a hand-computed golden."""
import io
import random

import numpy as np
import pytest

from kmergutsjava_tpu.cli import main as cli_main
from kmergutsjava_tpu.config import EngineConfig
from kmergutsjava_tpu.formats.table_tools import (signatures_from_proteins,
                                                  write_data_dir)
from kmergutsjava_tpu.models.pipeline import Engine

AA = "ACDEFGHIKLMNPQRSTVWY"
DNA = "ACGT"


def run_engine(data_dir, fasta_text, backend="xla", **cfg_kw):
    cfg = EngineConfig(backend=backend, **cfg_kw)
    out = io.StringIO()
    Engine(cfg).run(str(data_dir), None, out, stdout=True,
                    query_stream=io.StringIO(fasta_text))
    return out.getvalue()


def test_hand_golden_aa(tmp_path):
    prot = AA  # 20 residues: 13 full windows, 12 query windows (i < len-K)
    write_data_dir(tmp_path / "d", signatures_from_proteins(
        [(prot, 0, 3)], weight=0.5), ["funcA", "funcB"])
    fasta = ">P1 description\n" + prot + "\n"
    want = ("PROTEIN-ID\tP1\t20\n"
            "CALL\t0\t18\t12\t0\tfuncA\t6.000000\n"
            "OTU-COUNTS\tP1[20]\t12-3\n")
    for backend in ("parity", "xla"):
        assert run_engine(tmp_path / "d", fasta, backend=backend, aa=True) == want


def _random_corpus(rng, n_prot=40, n_funcs=6):
    prots = []
    for i in range(n_prot):
        length = rng.randint(12, 120)
        prots.append("".join(rng.choice(AA) for _ in range(length)))
    triples = [(p, rng.randrange(n_funcs), rng.randrange(10)) for p in prots]
    funcs = [f"function {i} description" for i in range(n_funcs)]
    return prots, triples, funcs


@pytest.mark.parametrize("min_hits,max_gap", [(5, 200), (2, 30), (3, 10)])
def test_cross_backend_aa_random(tmp_path, min_hits, max_gap):
    rng = random.Random(min_hits * 100 + max_gap)
    prots, triples, funcs = _random_corpus(rng)
    sig = signatures_from_proteins(triples, weights={i: 0.1 + 0.3 * i
                                                     for i in range(len(funcs))})
    # thin the signature set so some windows miss
    keep = np.asarray([rng.random() < 0.7 for _ in sig["kmers"]])
    sig = {k: v[keep] for k, v in sig.items()}
    write_data_dir(tmp_path / "d", sig, funcs, load_factor=0.9)
    fasta = "".join(f">p{i} d{i}\n{p}\n" for i, p in enumerate(prots))
    kw = dict(aa=True, min_hits=min_hits, max_gap=max_gap)
    r_parity = run_engine(tmp_path / "d", fasta, backend="parity", **kw)
    r_xla = run_engine(tmp_path / "d", fasta, backend="xla", **kw)
    r_stream = run_engine(tmp_path / "d", fasta, backend="stream", **kw)
    assert r_parity == r_xla == r_stream
    assert r_parity.count("PROTEIN-ID") == len(prots)
    assert "CALL\t" in r_parity


def test_cross_backend_dna_random(tmp_path):
    rng = random.Random(77)
    prots, triples, funcs = _random_corpus(rng, n_prot=20)
    sig = signatures_from_proteins(triples)
    write_data_dir(tmp_path / "d", sig, funcs)
    # DNA contigs: some random, some reverse-translated proteins so '+' and
    # '-' frames both get real hits
    from java_oracle import rev_comp
    codon = {"A": "GCT", "C": "TGT", "D": "GAT", "E": "GAA", "F": "TTT",
             "G": "GGT", "H": "CAT", "I": "ATT", "K": "AAA", "L": "CTT",
             "M": "ATG", "N": "AAT", "P": "CCT", "Q": "CAA", "R": "CGT",
             "S": "TCT", "T": "ACT", "V": "GTT", "W": "TGG", "Y": "TAT"}
    contigs = []
    for i, p in enumerate(prots[:8]):
        dna = "".join(codon[c] for c in p)
        prefix = "".join(rng.choice(DNA) for _ in range(rng.randrange(0, 5)))
        if i % 2:
            dna = rev_comp(dna)
        contigs.append(prefix + dna)
    for _ in range(4):
        contigs.append("".join(rng.choice(DNA + "nN")
                               for _ in range(rng.randint(30, 600))))
    fasta = "".join(f">c{i}\n{c}\n" for i, c in enumerate(contigs))
    kw = dict(aa=False, min_hits=3, max_gap=200)
    r_parity = run_engine(tmp_path / "d", fasta, backend="parity", **kw)
    r_xla = run_engine(tmp_path / "d", fasta, backend="xla", **kw)
    r_stream = run_engine(tmp_path / "d", fasta, backend="stream", **kw)
    assert r_parity == r_xla == r_stream
    assert r_parity.count("processing ") == len(contigs)
    assert r_parity.count("TRANSLATION") == 6 * len(contigs)
    assert "CALL\t" in r_parity


def test_duplicate_ids_last_container_wins(tmp_path):
    prot1, prot2 = AA, AA[::-1]
    write_data_dir(tmp_path / "d", signatures_from_proteins(
        [(prot1, 0, 1), (prot2, 1, 2)]), ["fA", "fB"])
    fasta = f">dup\n{prot1}\n>dup\n{prot2}\n"
    for backend in ("parity", "xla"):
        out = run_engine(tmp_path / "d", fasta, backend=backend, aa=True)
        # one PROTEIN-ID line (first-seen order), length/hits of the LAST record
        assert out.count("PROTEIN-ID\tdup\t20") == 1
        assert "fB" in out and "fA" not in out


def test_cli_file_output(tmp_path, capsys):
    prot = AA
    write_data_dir(tmp_path / "d", signatures_from_proteins(
        [(prot, 0, 3)], weight=0.5), ["funcA"])
    q = tmp_path / "q.faa"
    q.write_text(">P1\n" + prot + "\n")
    out_file = tmp_path / "out.txt"
    rc = cli_main(["-a", "-m", "5", "-D", str(tmp_path / "d"),
                   "-q", str(q), "-o", str(out_file)])
    assert rc == 0
    text = out_file.read_text()
    assert "CALL\t0\t18\t12\t0\tfuncA\t6.000000\n" in text
    # info lines go to stdout when output is a file (ref :891-898)
    captured = capsys.readouterr()
    assert "Preparation time:" in captured.out
    assert "Preparation time:" not in text


def test_cli_gz_inputs(tmp_path):
    import gzip
    prot = AA
    write_data_dir(tmp_path / "d", signatures_from_proteins(
        [(prot, 0, 3)], weight=0.5), ["funcA"], gz=True)
    q = tmp_path / "q.faa.gz"
    with gzip.open(q, "wt") as fh:
        fh.write(">P1\n" + prot + "\n")
    out_file = tmp_path / "out.txt"
    rc = cli_main(["-a", "-D", str(tmp_path / "d"), "-q", str(q),
                   "-o", str(out_file)])
    assert rc == 0
    assert "CALL\t0\t18\t12\t0\tfuncA\t6.000000\n" in out_file.read_text()


def test_cli_platform_flag(tmp_path):
    """--platform pins jax_platforms before the backend initializes."""
    import jax

    prot = AA
    write_data_dir(tmp_path / "d", signatures_from_proteins(
        [(prot, 0, 3)], weight=0.5), ["funcA"])
    q = tmp_path / "q.faa"
    q.write_text(">P1\n" + prot + "\n")
    out_file = tmp_path / "out.txt"
    rc = cli_main(["-a", "--platform", "cpu", "-D", str(tmp_path / "d"),
                   "-q", str(q), "-o", str(out_file)])
    assert rc == 0
    assert jax.config.jax_platforms == "cpu"
    assert "CALL\t0\t18\t12\t0\tfuncA\t6.000000\n" in out_file.read_text()


def test_cli_usage_on_error(capsys):
    rc = cli_main(["-Z"])
    assert rc == 2
    out = capsys.readouterr().out
    assert "Usage: kmer_guts" in out


def test_spill_path_end_to_end(tmp_path):
    """Tiny input_size_limit forces the external sort/merge path."""
    rng = random.Random(5)
    prots, triples, funcs = _random_corpus(rng, n_prot=10)
    write_data_dir(tmp_path / "d", signatures_from_proteins(triples), funcs)
    fasta = "".join(f">p{i}\n{p}\n" for i, p in enumerate(prots))
    base = run_engine(tmp_path / "d", fasta, backend="xla", aa=True, min_hits=2)
    spilled = run_engine(tmp_path / "d", fasta, backend="xla", aa=True,
                         min_hits=2, input_size_limit=50,
                         temp_dir=str(tmp_path / "tmp"))
    spilled_parity = run_engine(tmp_path / "d", fasta, backend="parity", aa=True,
                                min_hits=2, input_size_limit=50,
                                temp_dir=str(tmp_path / "tmp2"))
    assert base == spilled == spilled_parity


def test_cli_stdin_mode(tmp_path, monkeypatch, capsys):
    """Omitting -q reads stdin (the reference NPEs here, ref :647)."""
    import io
    import sys

    prot = AA
    write_data_dir(tmp_path / "d", signatures_from_proteins(
        [(prot, 0, 3)], weight=0.5), ["funcA"])
    monkeypatch.setattr(sys, "stdin", io.StringIO(">P1\n" + prot + "\n"))
    rc = cli_main(["-a", "-D", str(tmp_path / "d")])
    assert rc == 0
    assert "CALL\t0\t18\t12\t0\tfuncA\t6.000000" in capsys.readouterr().out


def test_jax_prepare_impl_end_to_end(tmp_path):
    rng = random.Random(9)
    prots, triples, funcs = _random_corpus(rng, n_prot=12)
    write_data_dir(tmp_path / "d", signatures_from_proteins(triples), funcs)
    fasta = "".join(f">p{i}\n{p}\n" for i, p in enumerate(prots))
    a = run_engine(tmp_path / "d", fasta, aa=True, min_hits=2,
                   prepare_impl="numpy")
    b = run_engine(tmp_path / "d", fasta, aa=True, min_hits=2,
                   prepare_impl="jax")
    assert a == b
    # DNA mode through both prepare impls
    contigs = "".join(f">c{i}\n" + "".join(rng.choice("ACGT")
                      for _ in range(200)) + "\n" for i in range(4))
    a = run_engine(tmp_path / "d", contigs, aa=False, min_hits=2,
                   prepare_impl="numpy")
    b = run_engine(tmp_path / "d", contigs, aa=False, min_hits=2,
                   prepare_impl="jax")
    assert a == b


STRIP_RE = None


def _strip_info(text):
    """Drop timing/progress info lines (nondeterministic) from debug reports."""
    import re

    drop = re.compile(r"^(Temp\. directory:|Preparation time:|Lookup time:"
                      r"|Grouping time:|Processed: )")
    return "\n".join(l for l in text.splitlines() if not drop.match(l))


def test_debug_mode_cross_backend(tmp_path):
    """Full debug reports (HIT/after-hit/after-call/Kmers found) agree
    across backends once timing lines are stripped."""
    rng = random.Random(55)
    prots, triples, funcs = _random_corpus(rng, n_prot=15)
    write_data_dir(tmp_path / "d", signatures_from_proteins(triples), funcs)
    fasta = "".join(f">p{i}\n{p}\n" for i, p in enumerate(prots))
    kw = dict(aa=True, min_hits=2, debug=True)
    a = _strip_info(run_engine(tmp_path / "d", fasta, backend="parity", **kw))
    b = _strip_info(run_engine(tmp_path / "d", fasta, backend="xla", **kw))
    assert a == b
    assert "HIT\t" in a and "after-hit: hits: " in a
    assert "Kmer-table info: numSigs=" in a
    assert "Kmers found: " in a


def test_order_constraint_and_weight_threshold_cross_backend(tmp_path):
    """-O and -M flags end-to-end: backends agree byte-for-byte."""
    rng = random.Random(91)
    prots, triples, funcs = _random_corpus(rng, n_prot=25)
    sig = signatures_from_proteins(triples, weights={i: 0.2 + 0.1 * i
                                                     for i in range(len(funcs))})
    write_data_dir(tmp_path / "d", sig, funcs)
    fasta = "".join(f">p{i}\n{p}\n" for i, p in enumerate(prots))
    for kw in (dict(order_constraint=True, min_hits=2),
               dict(min_weighted_hits=2, min_hits=2),
               dict(order_constraint=True, min_weighted_hits=1, min_hits=3)):
        a = run_engine(tmp_path / "d", fasta, backend="parity", aa=True, **kw)
        b = run_engine(tmp_path / "d", fasta, backend="xla", aa=True, **kw)
        assert a == b, kw
        assert a.count("PROTEIN-ID") == len(prots)


def test_engine_reuse_across_data_dirs(tmp_path):
    """The one-slot lookup cache must not leak answers across tables."""
    p1, p2 = AA, AA[::-1]
    write_data_dir(tmp_path / "d1", signatures_from_proteins([(p1, 0, 1)]),
                   ["only1"])
    write_data_dir(tmp_path / "d2", signatures_from_proteins([(p2, 0, 2)]),
                   ["only2"])
    fasta1, fasta2 = f">a\n{p1}\n", f">b\n{p2}\n"
    eng = Engine(EngineConfig(aa=True))
    outs = []
    for d, fasta in ((tmp_path / "d1", fasta1), (tmp_path / "d2", fasta2),
                     (tmp_path / "d1", fasta2)):
        out = io.StringIO()
        eng.run(str(d), None, out, stdout=True,
                query_stream=io.StringIO(fasta))
        outs.append(out.getvalue())
    assert "only1" in outs[0] and "only2" not in outs[0]
    assert "only2" in outs[1] and "only1" not in outs[1]
    assert "CALL" not in outs[2]  # p2's k-mers are not in d1's table


def test_combined_gz_spill_parity_dna(tmp_path):
    """gz table + gz query + spill limit + parity backend, DNA mode."""
    rng = random.Random(8)
    prots, triples, funcs = _random_corpus(rng, n_prot=8)
    write_data_dir(tmp_path / "d", signatures_from_proteins(triples), funcs,
                   gz=True)
    import gzip

    codon = {"A": "GCT", "C": "TGT", "D": "GAT", "E": "GAA", "F": "TTT",
             "G": "GGT", "H": "CAT", "I": "ATT", "K": "AAA", "L": "CTT",
             "M": "ATG", "N": "AAT", "P": "CCT", "Q": "CAA", "R": "CGT",
             "S": "TCT", "T": "ACT", "V": "GTT", "W": "TGG", "Y": "TAT"}
    fasta = "".join(f">c{i}\n" + "".join(codon[c] for c in p) + "\n"
                    for i, p in enumerate(prots[:5]))
    q = tmp_path / "q.fna.gz"
    with gzip.open(q, "wt") as fh:
        fh.write(fasta)
    out1 = tmp_path / "o1.txt"
    out2 = tmp_path / "o2.txt"
    assert cli_main(["-D", str(tmp_path / "d"), "-q", str(q), "-m", "3",
                     "-o", str(out1), "--backend", "parity", "-l", "40",
                     "-t", str(tmp_path / "tmp")]) == 0
    assert cli_main(["-D", str(tmp_path / "d"), "-q", str(q), "-m", "3",
                     "-o", str(out2)]) == 0
    assert out1.read_text() == out2.read_text()
    assert "CALL\t" in out1.read_text()


def test_auto_backend_resolution(tmp_path):
    """backend 'auto' picks stream for dense inputs, xla for sparse/stdin,
    routed for sparse with a mesh — and the report is identical either way."""
    import io

    from kmergutsjava_tpu.config import EngineConfig
    from kmergutsjava_tpu.formats.table_tools import (signatures_from_proteins,
                                                      write_data_dir)
    from kmergutsjava_tpu.models.pipeline import Engine, _auto_backend
    from kmergutsjava_tpu.formats.kmer_table import read_table, resolve_table_files

    aa = "ACDEFGHIKLMNPQRSTVWY"
    d = str(tmp_path / "d")
    write_data_dir(d, signatures_from_proteins([(aa, 0, 3)], weight=0.5),
                   ["funcA"])
    table = read_table(resolve_table_files(d)[0])
    fasta = tmp_path / "q.faa"
    fasta.write_text(">P1\n" + aa + "\n")

    cfg = EngineConfig(aa=True)
    # tiny table (dozens of slots) vs a ~30-byte file -> dense -> stream
    assert _auto_backend(table, str(fasta), cfg) == "stream"
    # stdin: unknown size -> None (defer to the mid-prepare decision)
    assert _auto_backend(table, None, cfg) is None
    cfg_mesh = EngineConfig(aa=True, mesh_shape=(4, 2))
    assert _auto_backend(table, None, cfg_mesh) is None

    # sparse: inflate num_sigs far beyond the estimate
    class FakeTable:
        num_sigs = 10**9
    assert _auto_backend(FakeTable, str(fasta), cfg) == "xla"

    outs = []
    for backend in ("auto", "xla"):
        out = io.StringIO()
        eng = Engine(EngineConfig(aa=True, backend=backend))
        eng.run(d, str(fasta), out, stdout=True)
        assert eng.config.backend == backend  # restored after the run
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert "CALL\t0\t18\t12\t0\tfuncA\t6.000000" in outs[0]


def test_auto_deferred_upgrades_to_stream(tmp_path):
    """Unknown-size input (query_stream) + dense corpus: the deferred auto
    feed crosses the density crossover (numSigs/DENSITY_CROSSOVER) mid-prepare, upgrades to the stream scatter,
    and the report matches the parity backend byte for byte."""
    rng = random.Random(99)
    prots, triples, funcs = _random_corpus(rng, n_prot=60)
    sig = signatures_from_proteins(triples)
    write_data_dir(tmp_path / "d", sig, funcs)
    fasta = "".join(f">p{i}\n{p}\n" for i, p in enumerate(prots))
    kw = dict(aa=True, min_hits=2)
    want = run_engine(tmp_path / "d", fasta, backend="parity", **kw)

    from kmergutsjava_tpu.models import pipeline as pl
    pl._LOOKUP_CACHE.clear()
    got = run_engine(tmp_path / "d", fasta, backend="auto", **kw)
    assert got == want
    # the dense corpus (thousands of windows vs a few-hundred-slot table)
    # must have taken the stream path
    assert any(k[0] == "stream" for k in pl._LOOKUP_CACHE)


def test_auto_deferred_stays_sparse_below_threshold(tmp_path):
    """Unknown-size input far below the crossover finishes on the sparse
    one-shot path (no stream lookup built), same bytes as parity."""
    rng = random.Random(7)
    prots, triples, funcs = _random_corpus(rng, n_prot=4)
    sig = signatures_from_proteins(triples)
    # tiny load factor inflates num_sigs so the threshold towers over the
    # handful of query windows
    write_data_dir(tmp_path / "d", sig, funcs, load_factor=0.002)
    fasta = "".join(f">p{i}\n{p}\n" for i, p in enumerate(prots))
    kw = dict(aa=True, min_hits=2)
    want = run_engine(tmp_path / "d", fasta, backend="parity", **kw)

    from kmergutsjava_tpu.models import pipeline as pl
    pl._LOOKUP_CACHE.clear()
    got = run_engine(tmp_path / "d", fasta, backend="auto", **kw)
    assert got == want
    assert not any(k[0] == "stream" for k in pl._LOOKUP_CACHE)


def test_auto_deferred_dna(tmp_path):
    """DNA mode through the deferred feed (6 containers per contig feed
    chunk-by-chunk across the upgrade boundary)."""
    rng = random.Random(31)
    prots, triples, funcs = _random_corpus(rng, n_prot=30)
    sig = signatures_from_proteins(triples)
    write_data_dir(tmp_path / "d", sig, funcs)
    codon = {"A": "GCT", "C": "TGT", "D": "GAT", "E": "GAA", "F": "TTT",
             "G": "GGT", "H": "CAT", "I": "ATT", "K": "AAA", "L": "CTT",
             "M": "ATG", "N": "AAT", "P": "CCT", "Q": "CAA", "R": "CGT",
             "S": "TCT", "T": "ACT", "V": "GTT", "W": "TGG", "Y": "TAT"}
    fasta = "".join(
        f">c{i}\n" + "".join(codon[ch] for ch in p) + "\n"
        for i, p in enumerate(prots))
    kw = dict(aa=False, min_hits=2)
    want = run_engine(tmp_path / "d", fasta, backend="parity", **kw)
    got = run_engine(tmp_path / "d", fasta, backend="auto", **kw)
    assert got == want
