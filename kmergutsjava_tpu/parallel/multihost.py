"""Multi-host execution helpers.

The reference is a single JVM with no distribution story (SURVEY.md §2.2);
the multi-host scaling path is:

- ``jax.distributed.initialize`` per host — the only process-level setup
  the engine needs;
- input sharding at the FASTA level: each host parses only its share of
  records (round-robin by record index, so no host-to-host data exchange is
  needed before the device phase);
- the (data, table) mesh from parallel/mesh spans all hosts; shard_map's
  psum hit-merge rides the interconnect automatically;
- hit containers are host-local (a record's 6 containers live where it was
  parsed), so the grouping phase and report emission need no collectives —
  each host writes its own report shard, and ``merge_report_shards``
  interleaves the shards back into reference record order for a
  byte-identical single report (verified end-to-end across a real
  2-process gloo cluster in tests/test_multiprocess.py).

Only single-process multi-device execution can be exercised in CI (see
__graft_entry__.dryrun_multichip which runs the full sharded step on a
virtual 8-device CPU mesh); this module carries the process bootstrap and
the record-sharding contract.
"""
from __future__ import annotations

from typing import Iterable, Iterator, Optional

from ..formats.fasta import FastaRecord


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Bring up the JAX distributed runtime (no-op for single process)."""
    import jax

    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def fetch_global(x):
    """device_get that also works when the array's mesh spans processes:
    non-addressable outputs (e.g. the data-sharded hit columns of the psum
    lookup on a multi-host mesh) are assembled with an allgather over the
    distributed runtime. Pytrees pass through leaf-wise."""
    import jax

    leaves = jax.tree_util.tree_leaves(x)
    if all(getattr(l, "is_fully_addressable", True) for l in leaves):
        return jax.device_get(x)
    from jax.experimental import multihost_utils

    return jax.tree_util.tree_map(
        lambda l: (jax.device_get(l)
                   if getattr(l, "is_fully_addressable", True)
                   else multihost_utils.process_allgather(l, tiled=True)), x)


def shard_records(records: Iterable[FastaRecord], process_id: int,
                  num_processes: int) -> Iterator[FastaRecord]:
    """Round-robin record assignment: host p takes records i with
    i % num_processes == p. Deterministic, order-preserving per host, and
    balanced for corpora of many records.

    Precondition for report parity: sequence ids must be unique across
    the corpus. The reference groups same-id sequences at the id's FIRST
    occurrence with the LAST occurrence's containers
    (KmerGutsJava.java:805-818), which record-level sharding cannot
    reproduce once occurrences land on different hosts (single-host runs
    and checkpointed runs both handle duplicates; see
    models/checkpoint.py)."""
    for i, rec in enumerate(records):
        if i % num_processes == process_id:
            yield rec


# Every non-debug report line belongs to exactly one record's block, and
# each block starts with exactly one of these (the reference output
# grammar): "PROTEIN-ID\t<id>\t<len>" opens an aa record
# (KmerGutsJava.java:529), "processing <id>[<len>]" opens a DNA record
# (:541); all other lines (TRANSLATION :545-548, CALL :398-404,
# OTU-COUNTS :516-522) continue the current block. Timing/progress lines
# only enter the report in debug mode (printInfoLine :891-898), which the
# multi-host path refuses like checkpointing does.
_BLOCK_HEADS = ("PROTEIN-ID\t", "processing ")


def split_report_blocks(report: str) -> list:
    """Split a NON-DEBUG report into its per-record blocks, in order.

    Raises ValueError on content before the first block head (debug info
    lines, or a report produced with debug=True) — merging such text
    would silently misplace lines."""
    blocks: list = []
    cur: Optional[list] = None
    for line in report.splitlines(keepends=True):
        if line.startswith(_BLOCK_HEADS):
            if cur is not None:
                blocks.append("".join(cur))
            cur = [line]
        elif cur is None:
            raise ValueError(
                "report text before the first record block (debug-mode "
                f"report?): {line[:80]!r}")
        else:
            cur.append(line)
    if cur is not None:
        blocks.append("".join(cur))
    return blocks


def merge_report_shards(shard_reports) -> str:
    """Interleave per-host report shards back into reference record order.

    ``shard_reports[p]`` must be the report text host ``p`` produced over
    its ``shard_records(records, p, P)`` share. Because round-robin
    assignment is order-preserving per host, global record k is block
    k // P of shard k % P; the merged text is byte-identical to a
    single-process run over the whole corpus (given the unique-id
    precondition of shard_records)."""
    per = [split_report_blocks(t) for t in shard_reports]
    nproc = len(per)
    total = sum(len(b) for b in per)
    out = []
    for k in range(total):
        shard = per[k % nproc]
        i = k // nproc
        if i >= len(shard):
            raise ValueError(
                f"shard {k % nproc} has only {len(shard)} blocks but "
                f"global record {k} maps to its block {i}: shards are not "
                "a round-robin partition of one corpus")
        out.append(shard[i])
    return "".join(out)
