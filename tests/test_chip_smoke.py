"""The parts of chip_smoke.py that run without a GPU: it refuses to run
off the card, its result line, its report comparison, and its strictness
about degraded backends and engine errors."""
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from kmergutsjava_tpu.formats.function_index import \
    write_function_index  # noqa: E402
from kmergutsjava_tpu.formats.kmer_table import (  # noqa: E402
    FUNCTION_INDEX_FILE, TABLE_FILE, build_table, write_table)
from kmergutsjava_tpu.formats.table_tools import (  # noqa: E402
    signatures_from_proteins, write_data_dir)

AA = "ACDEFGHIKLMNPQRSTVWY"


def _run_script(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_to_run_without_a_gpu():
    proc = _run_script(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_fails_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_script(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_result_line_format():
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev])
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert json.loads(chip_smoke.result_line([dev] * 4))["device"][
        "count"] == 4


REPORT = ("PROTEIN-ID\tP1\t20\nCALL\t0\t18\t12\t0\tfuncA\t6.000000\n"
          "OTU-COUNTS\tP1[20]\t6-3\n")


@pytest.mark.parametrize("where", [0, 17, len(REPORT) - 1, "short", "long"])
def test_report_comparison_catches_one_byte(where):
    if where == "short":
        got = REPORT[:-1]
    elif where == "long":
        got = REPORT + "\n"
    else:
        b = bytearray(REPORT.encode())
        b[where] ^= 1
        got = b.decode()
    chip_smoke.compare_reports("same", REPORT, REPORT)
    with pytest.raises(chip_smoke.SmokeError, match="differs"):
        chip_smoke.compare_reports("one byte", got, REPORT)


def test_report_blocks_split_by_protein():
    text = REPORT + REPORT.replace("P1", "P2")
    blocks = chip_smoke.report_blocks(text)
    assert list(blocks) == ["P1", "P2"]
    assert blocks["P1"] == REPORT


def _deep_chain_dir(d):
    """A table whose longest probe chain (80) exceeds the stream probe's
    packed-offset budget (64): backend stream degrades to parity."""
    s = 1009
    kmers = 5 + s * np.arange(1, 81, dtype=np.int64)
    n = len(kmers)
    table = build_table(kmers, np.zeros(n, np.int32),
                        np.zeros(n, np.int32), np.zeros(n, np.int32),
                        np.ones(n, np.float32), num_sigs=s)
    assert table.max_probe > 64
    os.makedirs(d)
    write_table(os.path.join(d, TABLE_FILE), table)
    write_function_index(os.path.join(d, FUNCTION_INDEX_FILE), ["funcA"])


def test_parity_fallback_fails_the_phase(tmp_path):
    d = str(tmp_path / "d")
    _deep_chain_dir(d)
    q = tmp_path / "q.fa"
    q.write_text(">P1\n" + AA + "\n")
    with pytest.raises(UserWarning, match="falling back to the parity"):
        chip_smoke.run_cli(["-a", "--backend", "stream", "-D", d,
                            "-q", str(q), "-o", str(tmp_path / "out")])


def test_engine_error_line_fails_the_phase(tmp_path):
    d = tmp_path / "d"
    write_data_dir(str(d), signatures_from_proteins([(AA, 0, 3)]), ["funcA"])
    path = d / TABLE_FILE
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) // 2)
    q = tmp_path / "q.fa"
    q.write_text(">P1\n" + AA + "\n")
    with pytest.raises(chip_smoke.SmokeError, match="Error:"):
        chip_smoke.run_cli(["-a", "-D", str(d), "-q", str(q),
                            "-o", str(tmp_path / "out")])


def test_clean_run_reports_its_times(tmp_path):
    d = tmp_path / "d"
    write_data_dir(str(d), signatures_from_proteins([(AA, 0, 3)],
                                                    weight=0.5), ["funcA"])
    q = tmp_path / "q.fa"
    q.write_text(">P1\n" + AA + "\n")
    times = chip_smoke.run_cli(["-a", "-D", str(d), "-q", str(q),
                                "-o", str(tmp_path / "out")])
    assert {"wall_s", "prep_ms", "lookup_ms", "group_ms"} <= set(times)
    assert "CALL\t0\t18\t12\t0\tfuncA\t6.000000" in (
        tmp_path / "out").read_text()


def test_split_fasta_keeps_records(tmp_path):
    text = "".join(f">r{i} d\n{'ACGT' * (i + 1)}\n{'GT' * i}\n"
                   for i in range(10))
    src = tmp_path / "in.fa"
    src.write_text(text)
    parts = chip_smoke.split_fasta(str(src), 3, str(tmp_path))
    chunks = [open(p).read() for p in parts]
    assert "".join(chunks) == text
    assert all(c.startswith(">") for c in chunks)
    assert [c.count(">") for c in chunks] == [3, 3, 4]


def test_parity_reference_by_parts_equals_whole(tmp_path):
    """The per-record report makes the parity reports of record ranges
    concatenate to the report of the whole input."""
    import random

    from test_end_to_end import _random_corpus

    rng = random.Random(5)
    prots, triples, funcs = _random_corpus(rng, n_prot=12)
    d = str(tmp_path / "d")
    write_data_dir(d, signatures_from_proteins(triples), funcs)
    fa = tmp_path / "q.fa"
    fa.write_text("".join(f">p{i}\n{p}\n" for i, p in enumerate(prots)))
    refs = chip_smoke.ParityRefs(d, str(tmp_path))
    try:
        refs.submit("whole", ["-a", "-m", "2"], str(fa))
        refs.submit("split", ["-a", "-m", "2"], str(fa), parts=3)
        whole = refs.get("whole")
        assert "CALL\t" in whole
        assert refs.get("split") == whole
    finally:
        refs.close()
