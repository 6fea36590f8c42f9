#!/usr/bin/env python
"""Randomized end-to-end soak: every backend must match parity byte-for-byte.

Each round builds a random signature table (random load factor, weights,
thinning) from a random corpus, then runs the full engine over a random
query set (aa or DNA, duplicates and near-misses mixed in) through every
backend — parity (the oracle transcription of the reference scan), xla,
stream, and auto (including the deferred stdin path) — with randomized
grouping parameters (min_hits, max_gap, order constraint, weight
threshold, occasional debug mode and scan grouping, occasional spill
limits). Any byte difference dumps the reproducing seed and exits 1.

Usage: python scripts/soak.py [seconds]   (default 600)
Env: SOAK_SEED to replay a failing round.
"""
import io
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the sharded/mesh variants need the virtual 8-device CPU mesh (like
# tests/conftest.py and bench_scaling.py); without it a mesh variant
# raises "need N devices", the engine's reference-faithful
# catch-and-continue (ref :797-802) emits a PARTIAL report, and the soak
# flags a confusing "divergence" (seed 152167206 documented this)
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from kmergutsjava_tpu.config import EngineConfig  # noqa: E402
from kmergutsjava_tpu.formats.table_tools import (  # noqa: E402
    signatures_from_proteins, write_data_dir)
from kmergutsjava_tpu.models.pipeline import Engine  # noqa: E402

AA = "ACDEFGHIKLMNPQRSTVWY"
_SPMD_DEFAULTS = None  # captured from models/spmd.py on first spmd round
DNA = "ACGT"
CODON = {"A": "GCT", "C": "TGT", "D": "GAT", "E": "GAA", "F": "TTT",
         "G": "GGT", "H": "CAT", "I": "ATT", "K": "AAA", "L": "CTT",
         "M": "ATG", "N": "AAT", "P": "CCT", "Q": "CAA", "R": "CGT",
         "S": "TCT", "T": "ACT", "V": "GTT", "W": "TGG", "Y": "TAT"}


def rev_comp(s):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    return "".join(comp[c] for c in reversed(s))


def run_round(seed: int, tmp: str) -> None:
    rng = random.Random(seed)
    n_funcs = rng.randint(2, 12)
    n_prot = rng.randint(5, 80)
    prots = ["".join(rng.choice(AA) for _ in range(rng.randint(10, 200)))
             for _ in range(n_prot)]
    triples = [(p, rng.randrange(n_funcs), rng.randrange(12)) for p in prots]
    weights = ({i: rng.random() * 3 for i in range(n_funcs)}
               if rng.random() < 0.5 else None)
    sig = signatures_from_proteins(triples, weights=weights)
    if rng.random() < 0.5 and len(sig["kmers"]) > 10:  # thin: some misses
        keep = np.asarray([rng.random() < rng.uniform(0.4, 0.95)
                           for _ in sig["kmers"]])
        sig = {k: v[keep] for k, v in sig.items()}
    d = os.path.join(tmp, f"d{seed}")
    write_data_dir(d, sig, [f"func {i}" for i in range(n_funcs)],
                   load_factor=rng.choice([0.3, 0.6, 0.8, 0.9, 0.95]),
                   gz=rng.random() < 0.2)

    aa = rng.random() < 0.5
    records = []
    source = list(prots)
    # ~1 round in 12 is LARGE so the native MT cutoffs (>=64k queries,
    # >=1MB feeder chars) genuinely engage under the randomized thread
    # counts below; small rounds stay fast
    n_reads = (rng.randint(1500, 4500) if rng.random() < 0.08
               else rng.randint(3, 60))
    for i in range(n_reads):
        p = rng.choice(source)
        if aa:
            seq = p if rng.random() < 0.7 else "".join(
                rng.choice(AA) for _ in range(rng.randint(9, 150)))
            # occasional mutation
            if rng.random() < 0.3 and len(seq) > 12:
                at = rng.randrange(len(seq))
                seq = seq[:at] + rng.choice(AA) + seq[at + 1:]
        else:
            dna = "".join(CODON[c] for c in p)
            if rng.random() < 0.4:
                dna = rev_comp(dna)
            if rng.random() < 0.4:
                dna = ("".join(rng.choice(DNA + "nN")
                               for _ in range(rng.randrange(0, 7))) + dna)
            if rng.random() < 0.2:
                dna = "".join(rng.choice(DNA + "N")
                              for _ in range(rng.randint(20, 400)))
            seq = dna
        records.append((f"s{i}", seq))
    # duplicate ids occasionally (last container wins, ref :805-809)
    if rng.random() < 0.15 and len(records) > 2:
        k = rng.randrange(len(records) - 1)
        records[k] = (records[-1][0], records[k][1])
    fasta = "".join(f">{rid} desc\n{seq}\n" for rid, seq in records)

    kw = dict(
        aa=aa,
        min_hits=rng.choice([2, 2, 3, 5]),
        max_gap=rng.choice([10, 50, 200, 600]),
        order_constraint=rng.random() < 0.2,
        min_weighted_hits=rng.choice([0, 0, 2]),  # int, ref Integer.parseInt :588
        debug=rng.random() < 0.1,
    )
    if rng.random() < 0.15:
        # spill/flush limit scaled to the round: a tiny limit on a LARGE
        # round would mean thousands of plane passes (minutes per round)
        kw["input_size_limit"] = (rng.randint(20_000, 200_000)
                                  if n_reads > 100 else rng.randint(40, 400))
        kw["temp_dir"] = os.path.join(tmp, f"t{seed}")
    variants = [("parity", {}), ("xla", {}), ("stream", {}), ("auto", {})]
    if rng.random() < 0.2 and kw["min_hits"] >= 2 and not kw["debug"]:
        variants.append(("xla", {"grouping_impl": "scan"}))
    if rng.random() < 0.25:
        # slot-range-sharded mesh lookup (fingerprint-candidate protocol,
        # host verification + collision fallback)
        variants.append(("sharded", {"mesh_shape": rng.choice(
            [(4, 2), (2, 4), (1, 8)])}))
    # forced-chunked probe (the large-plane auto default): tiny
    # thresholds make these small random tables exercise it, incl. the
    # bin-overflow fallback under the corpus' natural home clustering
    if rng.random() < 0.3:
        variants.append(("xla", {"_chunk_rows": rng.choice([8, 32, 64,
                                                            256])}))
    if rng.random() < 0.3:
        variants.append(("xla", {"prepare_impl": "numpy"}))
    if rng.random() < 0.3:
        # fused device prepare+lookup; occasional tiny window thresholds
        # force the sequence-parallel long-record routing
        import kmergutsjava_tpu.models.spmd as spmd_mod

        global _SPMD_DEFAULTS
        if _SPMD_DEFAULTS is None:
            _SPMD_DEFAULTS = (spmd_mod.LONG_AA, spmd_mod.WIN_AA,
                              spmd_mod.LONG_NT, spmd_mod.WIN_NT)
        if rng.random() < 0.3:
            spmd_mod.LONG_AA, spmd_mod.WIN_AA = 60, 32
            spmd_mod.LONG_NT, spmd_mod.WIN_NT = 150, 90
        else:
            (spmd_mod.LONG_AA, spmd_mod.WIN_AA,
             spmd_mod.LONG_NT, spmd_mod.WIN_NT) = _SPMD_DEFAULTS
        variants.append(("spmd", {}))
    import re

    # debug reports embed timing/progress info lines — nondeterministic
    drop = re.compile(r"^(Temp\. directory:|Preparation time:|Lookup time:"
                      r"|Grouping time:|Processed: )")
    strip = lambda t: "\n".join(l for l in t.splitlines()
                                if not drop.match(l))
    outs = []
    for backend, extra in variants:
        # randomize the native thread count per variant: any divergence
        # between thread counts (or vs the numpy twins) is a threading bug
        os.environ["KMER_NATIVE_THREADS"] = str(rng.choice([1, 2, 3, 4]))
        extra = dict(extra)
        chunk_rows = extra.pop("_chunk_rows", None)
        if chunk_rows is not None:
            # force the chunked impl (narrow-lane rows1 became the auto
            # default at every plane size, so auto no longer upgrades)
            os.environ["KMER_PROBE_IMPL"] = "chunked"
            os.environ["KMER_CHUNK_ROWS"] = str(chunk_rows)
        else:
            os.environ.pop("KMER_PROBE_IMPL", None)
            os.environ.pop("KMER_CHUNK_ROWS", None)
        cfg = EngineConfig(backend=backend, **{**kw, **extra})
        out = io.StringIO()
        Engine(cfg).run(d, None, out, stdout=True,
                        query_stream=io.StringIO(fasta))
        outs.append((backend, extra, strip(out.getvalue())))
    os.environ.pop("KMER_NATIVE_THREADS", None)
    os.environ.pop("KMER_PROBE_IMPL", None)
    os.environ.pop("KMER_CHUNK_ROWS", None)
    base = outs[0][2]
    for backend, extra, text in outs[1:]:
        if text != base:
            raise AssertionError(
                f"seed {seed}: backend {backend} {extra} diverged from "
                f"parity\n--- parity ---\n{base[:2000]}\n--- {backend} ---\n"
                f"{text[:2000]}")
    if rng.random() < 0.25 and not kw["debug"]:
        # checkpointed batched execution must reproduce the single-run
        # report byte-for-byte at any batch size (models/checkpoint.py) —
        # INCLUDING duplicate-id rounds (same-id sequences print at the
        # id's first occurrence; the batcher keeps all occurrences of an
        # id in one batch; refusal of these caught seed 253355989, the
        # span-aware batcher replaced it in round 3)
        from kmergutsjava_tpu.models.checkpoint import run_with_checkpoint

        qp = os.path.join(tmp, f"q{seed}.fa")
        op = os.path.join(tmp, f"o{seed}.txt")
        cp = os.path.join(tmp, f"c{seed}.ckpt")
        with open(qp, "w") as fh:
            fh.write(fasta)
        run_with_checkpoint(EngineConfig(**kw), d, qp, op, cp,
                            batch_groups=rng.randint(1, 7),
                            progress=False)
        with open(op) as fh:
            text = strip(fh.read())
        # the checkpoint path writes a pure report file (stdout=False:
        # info lines go to the console, not the report)
        if text != base:
            raise AssertionError(
                f"seed {seed}: checkpoint path diverged from parity\n"
                f"--- parity ---\n{base[:2000]}\n--- checkpoint ---\n"
                f"{text[:2000]}")
        for p in (qp, op, cp):
            os.unlink(p)


def main():
    deadline = time.time() + float(sys.argv[1] if len(sys.argv) > 1 else 600)
    import tempfile

    tmp = tempfile.mkdtemp(prefix="soak")
    if os.environ.get("SOAK_SEED"):
        run_round(int(os.environ["SOAK_SEED"]), tmp)
        print("seed OK")
        return
    base = random.SystemRandom().randrange(1 << 30)
    import shutil

    n = 0
    while time.time() < deadline:
        run_round(base + n, tmp)
        shutil.rmtree(os.path.join(tmp, f"d{base + n}"), ignore_errors=True)
        shutil.rmtree(os.path.join(tmp, f"t{base + n}"), ignore_errors=True)
        n += 1
        if n % 25 == 0:
            print(f"{n} rounds OK (last seed {base + n - 1})", flush=True)
        if n % 100 == 0:
            # every round jits fresh table shapes; thousands of cached
            # executables eventually exhaust the process map count
            # (observed: LLVM "Cannot allocate memory" after ~1.6k solo
            # rounds, and as early as ~175 when other jax processes share
            # the box's vm.max_map_count headroom — hence every 100)
            jax.clear_caches()
    print(f"SOAK PASSED: {n} rounds, base seed {base}")


if __name__ == "__main__":
    main()
