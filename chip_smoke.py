#!/usr/bin/env python
"""Run the annotator end to end on a GPU and check every report.

Usage:
    python chip_smoke.py             # one card: phases 1-6
    python chip_smoke.py --cards 4   # four cards: the mesh backends only

Everything runs in this one process, through the entry points a user calls
(``cli.main`` and the JSON-RPC service), on deployment data built from
``--seed`` and the vendored E. coli corpus (nothing is downloaded):

- table: the corpus signatures (the tests/corpus_util.py recipe) padded
  with seeded random signatures to 50M at load 0.6 — 83.3M slots, a 2 GB
  kmer.table.mem_map, loaded through the normal ``-D`` path;
- reads: 200,000 seeded 150 bp reads of the E. coli genome with 1%
  substitutions, ~50M query k-mers: above the ``auto`` backend's dense
  crossover, so ``auto`` must choose the dense stream probe.

Every report must be byte-identical to the ``--backend parity`` report of
the same input on the same table (lookup/parity.py, the host oracle, run in
a CPU-only child process), or to the committed golden:

1. proteome, aa mode, backend auto (the sparse probe)
2. genome, DNA mode, -m 5 -g 200, backend auto
3. reads, DNA mode, backend auto from a file (size-estimate route) and from
   stdin (deferred route), both on the dense probe; and backend xla, whose
   lookup time is the other side of the density crossover
4. backend spmd (fused device prepare and probe) on the proteome
5. the full-corpus goldens with backends auto and spmd
6. the JSON-RPC service on a thread of this process: status, warm, three
   annotate requests and one async job, against phase 1's report

With ``--cards 4`` only the mesh backends run (routed, sharded and stream
with ``--mesh 1x4``) on phase 1's and phase 3's inputs.

Engine warnings are errors (a backend that degrades to the parity scan
fails its phase), and so is an ``Error:`` info line. The script prints the
card, the JAX device and version, the native libraries, each phase's wall
and lookup times and the compile-cache counters; its last line is the JSON
result, printed only when every phase passed.
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import jax  # noqa: E402

import kmergutsjava_tpu  # noqa: E402,F401  (fails outside a checkout)

DATA = os.path.join(REPO, "tests", "data")
PROTEOME = os.path.join(DATA, "Ecoli_K12_W3110.faa.gz")
GENOME = os.path.join(DATA, "Ecoli_K12_W3110.fna.gz")
LOAD_FACTOR = 0.6
READ_LEN = 150
SUB_RATE = 0.01
PAD_FUNCTIONS = 4096  # function-index size of the padded table


class SmokeError(Exception):
    """A phase failed: wrong report, degraded backend, missing device."""


# ---------------------------------------------------------------- device


def pin_gpu() -> None:
    """Pin JAX to CUDA before first use, so a missing plugin is an error
    rather than a silent CPU run."""
    jax.config.update("jax_platforms", "cuda")
    try:
        backend = jax.default_backend()
    except (RuntimeError, AssertionError) as ex:  # no plugin or no card
        raise SmokeError(f"no CUDA device: {ex!r}") from ex
    if backend != "gpu":
        raise SmokeError(f"JAX backend is {backend!r}, not 'gpu'")


def card_info() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as ex:
        raise SmokeError(f"nvidia-smi failed: {ex}") from ex
    return "; ".join(ln.strip() for ln in out.splitlines() if ln.strip())


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def native_libs() -> dict:
    """Build/load every native host stage; all four must load."""
    from kmergutsjava_tpu.utils import native

    native.load_feeder()
    native.load_scatter()
    native.load_grouping()
    native.load_fasta()
    status = native.native_status()
    missing = {k: v for k, v in status.items() if v != "loaded"}
    if missing:
        raise SmokeError(f"native libraries not loaded: {missing}")
    return status


class CompileCounters:
    """Persistent-cache requests/hits and backend compile seconds, from
    JAX's monitoring events."""

    def __init__(self):
        self.requests = self.hits = 0
        self.compile_s = 0.0
        jax.monitoring.register_event_listener(self._event)
        jax.monitoring.register_event_duration_secs_listener(self._duration)

    def _event(self, name, **_):
        if name == "/jax/compilation_cache/compile_requests_use_cache":
            self.requests += 1
        elif name == "/jax/compilation_cache/cache_hits":
            self.hits += 1

    def _duration(self, name, secs, **_):
        if name == "/jax/core/compile/backend_compile_duration":
            self.compile_s += secs

    def summary(self) -> str:
        return (f"cache requests {self.requests}, hits {self.hits}, "
                f"misses {self.requests - self.hits}, backend compile "
                f"{self.compile_s:.1f} s")


# ------------------------------------------------------------------ data


def deployment_signatures(n_sigs: int, seed: int) -> dict:
    """The corpus signatures (every protein but each third, function
    i mod 97, otu i mod 20) plus seeded random signatures up to n_sigs."""
    from corpus_util import load_corpus

    from kmergutsjava_tpu.constants import MAX_ENCODED
    from kmergutsjava_tpu.formats.table_tools import signatures_from_proteins

    prots, _ = load_corpus()
    sig = signatures_from_proteins(
        [(p.seq, i % 97, i % 20) for i, p in enumerate(prots) if i % 3 != 2])
    n_pad = max(0, n_sigs - len(sig["kmers"]))
    rng = np.random.default_rng(seed)
    pad = np.unique(rng.integers(0, MAX_ENCODED + 1,
                                 int(n_pad * 1.02) + 1024, dtype=np.int64))
    pad = pad[~np.isin(pad, sig["kmers"])]
    pad = rng.permutation(pad)[:n_pad]
    m = len(pad)
    return dict(
        kmers=np.concatenate([sig["kmers"], pad]),
        otu=np.concatenate([sig["otu"],
                            rng.integers(0, 1000, m).astype(np.int32)]),
        avg_from_end=np.concatenate([
            sig["avg_from_end"], rng.integers(0, 500, m).astype(np.int32)]),
        fi=np.concatenate([sig["fi"], rng.integers(
            0, PAD_FUNCTIONS, m).astype(np.int32)]),
        wt=np.concatenate([sig["wt"], rng.random(m).astype(np.float32)]))


def write_deployment(data_dir: str, n_sigs: int, seed: int):
    from kmergutsjava_tpu.formats.table_tools import write_data_dir

    funcs = [f"ecoli function {i}" if i < 97 else f"padding function {i}"
             for i in range(PAD_FUNCTIONS)]
    return write_data_dir(data_dir, deployment_signatures(n_sigs, seed),
                          funcs, load_factor=LOAD_FACTOR)


def write_reads(path: str, n_reads: int, seed: int) -> None:
    """Seeded reads of the genome, half reverse-complemented, with
    SUB_RATE substitutions to another base."""
    from corpus_util import load_corpus

    _, contig = load_corpus()
    code = np.full(256, 0, np.uint8)
    for i, ch in enumerate(b"ACGT"):
        code[ch] = i
    g = code[np.frombuffer(contig.seq.encode(), np.uint8)]
    rng = np.random.default_rng(seed + 1)
    starts = rng.integers(0, len(g) - READ_LEN, n_reads)
    reads = g[starts[:, None] + np.arange(READ_LEN)]
    subs = rng.random(reads.shape) < SUB_RATE
    reads[subs] = (reads[subs] + rng.integers(1, 4, int(subs.sum()))) % 4
    rc = rng.random(n_reads) < 0.5
    reads[rc] = 3 - reads[rc][:, ::-1]
    seqs = np.frombuffer(b"ACGT", np.uint8)[reads]
    with open(path, "wb") as fh:
        for i in range(n_reads):
            fh.write(b">r%d\n" % i)
            fh.write(seqs[i].tobytes())
            fh.write(b"\n")


# ------------------------------------------------------------- reports


def compare_reports(name: str, got: str, want: str) -> None:
    if got == want:
        return
    i = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    line = got.count("\n", 0, i) + 1
    raise SmokeError(
        f"{name}: report differs from the reference at byte {i} (line "
        f"{line}): got {got[i:i + 40]!r}, want {want[i:i + 40]!r} "
        f"({len(got)} vs {len(want)} bytes)")


def report_blocks(report: str) -> dict:
    """aa-mode report -> {protein id: its PROTEIN-ID..OTU-COUNTS lines}."""
    blocks, cur = {}, None
    for ln in report.splitlines(keepends=True):
        if ln.startswith("PROTEIN-ID\t"):
            cur = ln.split("\t")[1]
            blocks[cur] = ""
        blocks[cur] += ln
    return blocks


@contextlib.contextmanager
def strict_warnings():
    """Warnings raised inside engine calls become errors, so a backend
    that degrades to the parity scan fails loudly."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        warnings.simplefilter("default", DeprecationWarning)
        warnings.simplefilter("default", PendingDeprecationWarning)
        yield


def run_cli(args, stdin_path=None) -> dict:
    """cli.main in this process with -o; returns its info-line times.
    Fails on a non-zero exit, a warning, or an ``Error:`` info line."""
    from kmergutsjava_tpu import cli

    buf = io.StringIO()
    saved_stdin = sys.stdin
    t = time.perf_counter()
    try:
        with contextlib.ExitStack() as stack:
            if stdin_path is not None:
                sys.stdin = stack.enter_context(open(stdin_path))
            stack.enter_context(strict_warnings())
            stack.enter_context(contextlib.redirect_stdout(buf))
            rc = cli.main(list(args))
    finally:
        sys.stdin = saved_stdin
    wall = time.perf_counter() - t
    info = buf.getvalue()
    if rc != 0:
        raise SmokeError(f"cli exit {rc}: {info[-2000:]}")
    errors = [ln for ln in info.splitlines() if ln.startswith("Error:")]
    if errors:
        raise SmokeError(f"engine reported {errors[0]!r}")
    times = {"wall_s": wall}
    for ln in info.splitlines():
        for key, label in (("prep_ms", "Preparation time: "),
                           ("lookup_ms", "Lookup time: "),
                           ("group_ms", "Grouping time: ")):
            if ln.startswith(label):
                times[key] = int(ln[len(label):].split()[0])
    return times


def split_fasta(path: str, parts: int, workdir: str) -> list:
    """Cut an uncompressed FASTA at record boundaries into ``parts`` files
    of nearly equal record counts; returns their paths in input order."""
    with open(path, "rb") as fh:
        data = fh.read()
    b = np.frombuffer(data, np.uint8)
    heads = np.concatenate([[0], np.nonzero(
        (b[1:] == ord(">")) & (b[:-1] == ord("\n")))[0] + 1])
    cuts = [int(heads[len(heads) * k // parts]) for k in range(parts)]
    cuts.append(len(data))
    paths = []
    for k in range(parts):
        p = os.path.join(workdir, f"{os.path.basename(path)}.part{k}")
        with open(p, "wb") as fh:
            fh.write(data[cuts[k]:cuts[k + 1]])
        paths.append(p)
    return paths


class ParityRefs:
    """Parity-backend reports, computed by CPU-only child processes while
    the device phases run. A many-record input is cut into record ranges
    run side by side: the report is per record (no state crosses records),
    so the parts' reports concatenate to the report of the whole input."""

    def __init__(self, data_dir: str, workdir: str, workers: int = 8):
        self.data_dir, self.workdir = data_dir, workdir
        self._pool = ThreadPoolExecutor(workers)
        self._jobs = {}
        self._reported = set()

    def submit(self, name: str, args, fasta: str, parts: int = 1) -> None:
        paths = ([fasta] if parts == 1
                 else split_fasta(fasta, parts, self.workdir))
        self._jobs[name] = [
            self._pool.submit(self._run, f"{name}{k}", list(args) + ["-q", p])
            for k, p in enumerate(paths)]

    def _run(self, name, args) -> str:
        out = os.path.join(self.workdir, f"parity_{name}.txt")
        env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
        cmd = [sys.executable, "-m", "kmergutsjava_tpu.cli", "--platform",
               "cpu", "--backend", "parity", "-D", self.data_dir,
               "-t", self.workdir, "-o", out] + args
        t = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                              text=True)
        if proc.returncode or "Error:" in proc.stdout:
            raise SmokeError(f"parity {name} failed: {proc.stdout[-1000:]}"
                             f"{proc.stderr[-2000:]}")
        with open(out) as fh:
            return fh.read(), time.perf_counter() - t

    def get(self, name: str) -> str:
        """The reference report; the first call also prints its host time
        (from this thread: engine runs capture sys.stdout while they run)."""
        parts = [f.result() for f in self._jobs[name]]
        if name not in self._reported:
            self._reported.add(name)
            print(f"  parity {name}: {len(parts)} part(s), longest "
                  f"{max(s for _, s in parts):.1f} s on the host", flush=True)
        return "".join(text for text, _ in parts)

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)


def _read(path: str) -> str:
    with open(path) as fh:
        return fh.read()


def _dense_ran() -> bool:
    from kmergutsjava_tpu.models import pipeline

    return any(k[0] == "stream" for k in pipeline._LOOKUP_CACHE)


def _fresh_lookups() -> None:
    from kmergutsjava_tpu.models import pipeline

    pipeline._LOOKUP_CACHE.clear()


def _fmt(times: dict) -> str:
    return (f"wall {times['wall_s']:.2f} s, lookup {times.get('lookup_ms')}"
            f" ms (prepare {times.get('prep_ms')} ms, grouping "
            f"{times.get('group_ms')} ms)")


# ---------------------------------------------------------------- phases


class Smoke:
    def __init__(self, args, workdir: str):
        self.args, self.work = args, workdir
        self.data = os.path.join(workdir, "data")
        self.reads = os.path.join(workdir, "reads.fa")
        self.parity = None
        self.log = []

    def out(self, name: str) -> str:
        return os.path.join(self.work, f"{name}.txt")

    def engine(self, name: str, args, stdin_path=None, ref=None,
               want_dense=None) -> dict:
        """One checked engine run: report vs its reference, and (where
        asked) whether the dense stream probe served the lookup."""
        _fresh_lookups()
        out = self.out(name)
        times = run_cli(["-D", self.data, "-t", self.work, "-o", out]
                        + list(args), stdin_path)
        got = _read(out)
        if ref is not None:
            compare_reports(name, got, ref)
        dense = _dense_ran()
        if want_dense is not None and dense != want_dense:
            raise SmokeError(f"{name}: dense path ran={dense}, "
                             f"expected {want_dense}")
        times["dense"] = dense
        print(f"  {name}: {_fmt(times)}, dense={dense}, "
              f"{len(got)} report bytes"
              + (", identical to the reference" if ref is not None else ""),
              flush=True)
        self.log.append((name, times))
        return times

    def build(self) -> None:
        a = self.args
        t = time.perf_counter()
        table = write_deployment(self.data, a.sigs, a.seed)
        t_table = time.perf_counter() - t
        write_reads(self.reads, a.reads, a.seed)
        size = os.path.getsize(os.path.join(self.data, "kmer.table.mem_map"))
        print(f"data: {table.num_sigs} slots, max probe {table.max_probe}, "
              f"{size} table bytes in {t_table:.1f} s; {a.reads} reads in "
              f"{time.perf_counter() - t - t_table:.1f} s", flush=True)
        self.parity = ParityRefs(self.data, self.work)

    def phase(self, label: str, fn) -> None:
        print(f"phase {label}", flush=True)
        t = time.perf_counter()
        fn()
        print(f"phase {label}: passed in {time.perf_counter() - t:.1f} s",
              flush=True)

    # -- one card ------------------------------------------------------

    def proteome(self) -> None:
        self.engine("proteome_auto", ["-a", "-q", PROTEOME],
                    ref=self.parity.get("proteome"))

    def genome(self) -> None:
        self.engine("genome_auto", ["-m", "5", "-g", "200", "-q", GENOME],
                    ref=self.parity.get("genome"))

    def reads_phase(self) -> None:
        ref = self.parity.get("reads")
        a = self.engine("reads_auto_file", ["-q", self.reads], ref=ref,
                        want_dense=True)
        b = self.engine("reads_auto_stdin", [], stdin_path=self.reads,
                        ref=ref, want_dense=True)
        x = self.engine("reads_xla", ["--backend", "xla", "-q", self.reads],
                        ref=ref, want_dense=False)
        print(f"  density crossover: dense (stream) lookup "
              f"{a['lookup_ms']} ms, wall {a['wall_s']:.2f} s (file) / "
              f"{b['lookup_ms']} ms, {b['wall_s']:.2f} s (stdin) vs sparse "
              f"xla lookup {x['lookup_ms']} ms, wall {x['wall_s']:.2f} s",
              flush=True)

    def spmd(self) -> None:
        self.engine("proteome_spmd", ["-a", "--backend", "spmd", "-q",
                                      PROTEOME],
                    ref=self.parity.get("proteome"))

    def goldens(self) -> None:
        from corpus_util import build_corpus_data_dir, load_corpus

        prots, contig = load_corpus()
        gdir = os.path.join(self.work, "golden_data")
        build_corpus_data_dir(gdir, prots)
        inputs = {
            "aa": "".join(f">{p.id} {p.descr}\n{p.seq}\n" for p in prots),
            "dna": f">{contig.id} {contig.descr}\n{contig.seq}\n"}
        for mode, text in inputs.items():
            q = os.path.join(self.work, f"golden_{mode}.fa")
            with open(q, "w") as fh:
                fh.write(text)
            with gzip.open(os.path.join(DATA, f"golden_{mode}_full.txt.gz"),
                           "rt") as fh:
                want = fh.read()
            for backend in ("auto", "spmd"):
                name = f"golden_{mode}_{backend}"
                _fresh_lookups()
                out = self.out(name)
                times = run_cli(["-D", gdir, "-t", self.work, "-o", out,
                                 "--backend", backend, "-q", q]
                                + (["-a"] if mode == "aa" else []))
                compare_reports(name, _read(out), want)
                print(f"  {name}: {_fmt(times)}, identical to the golden",
                      flush=True)
                self.log.append((name, times))

    def service(self) -> None:
        from kmergutsjava_tpu.formats.fasta import read_fasta
        from kmergutsjava_tpu.service.client import KmerGutsClient
        from kmergutsjava_tpu.service.server import serve

        blocks = report_blocks(_read(self.out("proteome_auto")))
        recs = list(read_fasta(PROTEOME))
        server = serve(self.data, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            port = server.server_address[1]
            c = KmerGutsClient(f"http://127.0.0.1:{port}", timeout=1200)
            with strict_warnings():
                st = c.status()
                if st.get("state") != "OK":
                    raise SmokeError(f"status: {st}")
                w = c.warm()
                print(f"  warm: {w}", flush=True)
                subsets = [recs[0:200], recs[5000:5100], recs[-300:],
                           recs[9000:9400]]
                for i, sub in enumerate(subsets):
                    fasta = "".join(f">{r.id} {r.descr}\n{r.seq}\n"
                                    for r in sub)
                    want = "".join(blocks[r.id] for r in sub)
                    t = time.perf_counter()
                    if i < 3:
                        got, kind = c.annotate(fasta=fasta, aa=True), \
                            "annotate"
                    else:
                        got, kind = c.annotate_async(fasta=fasta, aa=True), \
                            "_annotate_submit/_check_job"
                    compare_reports(f"service {kind} {i}", got, want)
                    print(f"  {kind} of {len(sub)} proteins: "
                          f"{time.perf_counter() - t:.2f} s, identical to "
                          f"phase 1", flush=True)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)

    # -- four cards ----------------------------------------------------

    def mesh(self) -> None:
        n = len(jax.devices())
        if n < 4:
            raise SmokeError(f"--cards 4 needs 4 devices, JAX sees {n}")
        # proteome runs first: the reads' parity report takes longest
        for name, args in (("proteome", ["-a", "-q", PROTEOME]),
                           ("reads", ["-q", self.reads])):
            for backend in ("routed", "sharded", "stream"):
                self.engine(f"{name}_{backend}_mesh",
                            ["--backend", backend, "--mesh", "1x4"] + args,
                            ref=self.parity.get(name))
                used = devices_holding_table()
                if len(used) < 4:
                    raise SmokeError(f"{backend}: table on devices {used}, "
                                     f"not on 4 cards")
                print(f"  {backend}: table sharded over devices {used}",
                      flush=True)


def devices_holding_table() -> list:
    """Ids of the devices holding the table planes of the last run's
    cached lookup (stream, routed or sharded)."""
    from kmergutsjava_tpu.models import pipeline

    for lk in pipeline._LOOKUP_CACHE.values():
        planes = (lk[2] if isinstance(lk, tuple) else
                  getattr(lk, "fp_blocks", getattr(lk, "fp_shards", None)))
        leaves = jax.tree_util.tree_leaves(planes)
        if leaves:
            return sorted({d.id for x in leaves for d in x.devices()})
    return []


def run(args) -> None:
    """All phases; raises SmokeError on the first failure."""
    print(f"jax {jax.__version__}, device {jax.devices()[0].device_kind}, "
          f"{len(jax.devices())} visible", flush=True)
    from kmergutsjava_tpu import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    counters = CompileCounters()
    print(f"native libraries: {native_libs()}", flush=True)
    workdir = tempfile.mkdtemp(prefix="kmer_smoke_")
    s = Smoke(args, workdir)
    try:
        s.build()
        s.parity.submit("proteome", ["-a"], PROTEOME)
        if args.cards == 1:
            s.parity.submit("genome", ["-m", "5", "-g", "200"], GENOME)
        s.parity.submit("reads", [], s.reads, parts=8)
        if args.cards == 4:
            s.phase("4-card mesh (routed, sharded, stream)", s.mesh)
        else:
            s.phase("1 proteome auto", s.proteome)
            s.phase("2 genome auto", s.genome)
            s.phase("4 spmd", s.spmd)
            s.phase("5 goldens", s.goldens)
            s.phase("6 service", s.service)
            s.phase("3 reads (dense)", s.reads_phase)
    finally:
        if s.parity is not None:
            s.parity.close()
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"compile: {counters.summary()}", flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--sigs", type=int, default=50_000_000,
                    help="table signatures (smaller for rehearsals)")
    ap.add_argument("--reads", type=int, default=200_000,
                    help="reads (smaller for rehearsals)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    t = time.perf_counter()
    try:
        pin_gpu()
        print(f"card: {card_info()}", flush=True)
        run(args)
    except SmokeError as ex:
        print(f"FAILED: {ex}", file=sys.stderr, flush=True)
        return 1
    print(f"all phases passed in {time.perf_counter() - t:.1f} s",
          flush=True)
    print(result_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
