"""Out-of-core query k-mer store: bounded-RAM accumulate, spill, merge.

Counterpart of the reference's external merge sort
(createKmerStorage, KmerGutsJava.java
:822-889; spill/merge :656-740): query k-mers accumulate in RAM up to
``input_size_limit``; overflow chunks are sorted by (home, value) — the
reference's comparator (ref :1082-1094) — and spilled as binary files; a
pairwise merge cascade (ref :717-740) yields one sorted stream.

Differences by design (same capability, columnar instead of record-at-a-time):

- records are numpy batches, spilled as a structured array file and merged
  with vectorized block merges (searchsorted splits) instead of per-record
  Java object streams;
- sortedness is only *required* by the parity backend's streaming scan; the
  vectorized backends are order-independent, so the in-RAM path skips the
  sort unless asked for it.
"""
from __future__ import annotations

import os
import tempfile
from typing import List, Optional

import numpy as np

REC_DTYPE = np.dtype([("value", "<i8"), ("cnt", "<i4"), ("pos", "<i4")])


def sort_records(rec: np.ndarray, num_sigs: int) -> np.ndarray:
    home = rec["value"] % np.int64(num_sigs)
    order = np.lexsort((rec["value"], home))
    return rec[order]


def _lex_le_split(a_home, a_val, b_home0, b_val0) -> int:
    """Number of leading records of sorted (a_home, a_val) <= (b_home0, b_val0)."""
    i1 = int(np.searchsorted(a_home, b_home0, side="left"))
    i2 = int(np.searchsorted(a_home, b_home0, side="right"))
    j = int(np.searchsorted(a_val[i1:i2], b_val0, side="right"))
    return i1 + j


def merge_two_sorted_files(f1: str, f2: str, out: str, num_sigs: int,
                           block: int = 1 << 20) -> None:
    """Streaming merge of two (home, value)-sorted record files."""
    a = np.memmap(f1, dtype=REC_DTYPE, mode="r")
    b = np.memmap(f2, dtype=REC_DTYPE, mode="r")
    ns = np.int64(num_sigs)
    with open(out, "wb") as fh:
        ai = bi = 0
        a_blk: Optional[np.ndarray] = None
        b_blk: Optional[np.ndarray] = None
        a_off = b_off = 0
        while True:
            if a_blk is None or a_off >= len(a_blk):
                a_blk = np.asarray(a[ai: ai + block])
                ai += len(a_blk)
                a_off = 0
            if b_blk is None or b_off >= len(b_blk):
                b_blk = np.asarray(b[bi: bi + block])
                bi += len(b_blk)
                b_off = 0
            a_rest = a_blk[a_off:]
            b_rest = b_blk[b_off:]
            if len(a_rest) == 0 and len(b_rest) == 0:
                if ai >= len(a) and bi >= len(b):
                    break
                continue
            if len(a_rest) == 0:
                if ai < len(a):
                    continue
                b_rest.tofile(fh)
                b_off += len(b_rest)
                continue
            if len(b_rest) == 0:
                if bi < len(b):
                    continue
                a_rest.tofile(fh)
                a_off += len(a_rest)
                continue
            a_home = a_rest["value"] % ns
            b_home = b_rest["value"] % ns
            cut_a = _lex_le_split(a_home, a_rest["value"], b_home[0], b_rest["value"][0])
            if cut_a > 0:
                a_rest[:cut_a].tofile(fh)
                a_off += cut_a
            else:
                cut_b = _lex_le_split(b_home, b_rest["value"], a_home[0], a_rest["value"][0])
                cut_b = max(cut_b, 1)
                b_rest[:cut_b].tofile(fh)
                b_off += cut_b


class QueryKmerStore:
    """Accumulate (value, container, pos) batches with bounded RAM."""

    def __init__(self, num_sigs: int, input_size_limit: int,
                 temp_dir: Optional[str] = None):
        self.num_sigs = num_sigs
        self.limit = int(input_size_limit)
        self.temp_dir = temp_dir or tempfile.gettempdir()
        self._batches: List[np.ndarray] = []
        self._count = 0
        self._files: List[str] = []
        self._final: Optional[np.ndarray] = None
        self._final_file: Optional[str] = None

    @property
    def total_added(self) -> int:
        return self._count + sum(len(np.memmap(f, dtype=REC_DTYPE, mode="r"))
                                 for f in self._files)

    def add_batch(self, values: np.ndarray, cnt_id: int, pos: np.ndarray) -> None:
        n = len(values)
        if n == 0:
            return
        rec = np.empty(n, dtype=REC_DTYPE)
        rec["value"] = values
        rec["cnt"] = cnt_id
        rec["pos"] = pos
        self._batches.append(rec)
        self._count += n
        if self._count >= self.limit:
            self._spill()

    def _spill(self) -> None:
        if not self._batches:
            return
        os.makedirs(self.temp_dir, exist_ok=True)
        rec = sort_records(np.concatenate(self._batches), self.num_sigs)
        path = os.path.join(self.temp_dir, f"query_kmers_{len(self._files)}.dat")
        rec.tofile(path)
        self._files.append(path)
        self._batches = []
        self._count = 0

    def finalize(self, require_sorted: bool = False) -> np.ndarray:
        """Return all records; sorted by (home, value) if spilled or requested."""
        if self._final is not None:
            return self._final
        if self._files:
            self._spill()
            files = list(self._files)
            gen = len(files)
            while len(files) > 1:
                nxt = []
                while files:
                    f1 = files.pop(0)
                    if files:
                        f2 = files.pop(0)
                        out = os.path.join(self.temp_dir, f"query_kmers_{gen}.dat")
                        gen += 1
                        merge_two_sorted_files(f1, f2, out, self.num_sigs)
                        os.remove(f1)
                        os.remove(f2)
                        nxt.append(out)
                    else:
                        nxt.append(f1)
                files = nxt
            self._final_file = files[0]
            self._final = np.memmap(self._final_file, dtype=REC_DTYPE, mode="r")
        else:
            rec = (np.concatenate(self._batches) if self._batches
                   else np.empty(0, dtype=REC_DTYPE))
            self._batches = []
            if require_sorted and len(rec):
                rec = sort_records(rec, self.num_sigs)
            self._final = rec
        return self._final

    def close(self) -> None:
        self._batches = []
        self._final = None
        if self._final_file and os.path.exists(self._final_file):
            os.remove(self._final_file)
        for f in self._files:
            if os.path.exists(f):
                os.remove(f)
        self._files = []
