"""ctypes loaders for the native components (kmergutsjava_tpu/native/*.cpp).

Each loader builds its shared library on demand with g++ (or use
``make all``) beside its source, and returns None when the build fails, so
callers fall back to their numpy twins; ``native_status()`` says which
libraries loaded and why the others did not. The sources ship as package
data, so installed copies (pip/Docker) get the native paths too.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()

_SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_U16P = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def _build(name: str) -> ctypes.CDLL:
    """Build (when missing or older than its sources) and load one
    library. Compiles to a private temp file and renames it into place, so
    processes building the same library at once never load a half-written
    file."""
    src = os.path.join(_SRC_DIR, name + ".cpp")
    hdr = os.path.join(_SRC_DIR, "threading.h")
    so = os.path.join(_SRC_DIR, name + ".so")
    src_mtime = os.path.getmtime(src)
    if os.path.exists(hdr):
        src_mtime = max(src_mtime, os.path.getmtime(hdr))
    if not os.path.exists(so) or os.path.getmtime(so) < src_mtime:
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC",
                                   "-pthread", "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode:
                raise OSError(f"g++ failed: {proc.stderr.strip()[-500:]}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(so)


_libs: dict = {}
_errors: dict = {}  # name -> why the library is unavailable


def native_status() -> dict:
    """name -> "loaded" or the reason it is not, for every library a
    loader has been asked for so far."""
    with _lock:
        return {name: "loaded" if lib is not None else _errors.get(name, "")
                for name, lib in _libs.items()}


def _load(name: str, env_off: str, bind) -> Optional[ctypes.CDLL]:
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = None
        if os.environ.get(env_off):
            _errors[name] = f"disabled by {env_off}"
        else:
            try:
                lib = _build(name)
                bind(lib)
            except (OSError, AttributeError) as ex:
                _errors[name] = f"{type(ex).__name__}: {ex}"
                lib = None
        _libs[name] = lib
        return lib


def _bind_feeder(lib) -> None:
    for fname in ("feeder_aa", "feeder_dna"):
        fn = getattr(lib, fname)
        fn.restype = ctypes.c_int64
        fn.argtypes = [_U8P, _I64P, _I64P, ctypes.c_int64, _I64P,
                       _U8P, _I64P, _I32P, _I32P]


def load_feeder() -> Optional[ctypes.CDLL]:
    return _load("feeder", "KMER_NO_NATIVE_FEEDER", _bind_feeder)


def _bind_scatter(lib) -> None:
    fn = lib.scatter_chunk
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        _I64P, ctypes.c_int64,                        # values, n
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,               # dims, fp_mod
        _U16P, _U8P,                                  # tiles, occ
        _I64P, _I64P, _I32P,                          # homes, flat, shift
    ]
    fn = lib.resolve_slots
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        _I64P, _I64P, _I64P, _I32P,                   # v, homes, flat, shift
        ctypes.c_int64,                               # n
        _I32P, _U8P, _I64P,                           # out, fe, hk
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # hk_len, w, full_w
        _I64P,                                        # slots out
    ]
    fn = lib.table_place
    fn.restype = ctypes.c_int64
    fn.argtypes = [_I64P, _I64P, ctypes.c_int64, ctypes.c_int64, _I64P]
    fn = lib.table_fill
    fn.restype = None
    fn.argtypes = [_I64P, _I64P, ctypes.c_int64, _I64P, _I32P, _I32P, _I32P,
                   _F32P, _U8P]
    fn = lib.emit_hits
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        _I64P, _I64P, _I64P, _I64P,                   # v, cnt, pos, slots
        ctypes.c_int64,                               # n
        _I32P, _I32P, _I32P, _F32P,                   # table columns
        _I64P, _I64P, _I32P, _I32P, _I32P, _F32P,     # hit columns out
        _I64P,                                        # hit values out
    ]
    fn = lib.gather_resolve_slots
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        _I64P, _I32P, _U8P, _U8P,                     # v, homes, off, state
        ctypes.c_int64,                               # n
        _I64P, ctypes.c_int64, ctypes.c_int64,        # hk, hk_len, full_w
        _I64P,                                        # slots out
    ]
    fn = lib.bin_queries
    fn.restype = None
    fn.argtypes = [
        _I32P, _U16P, ctypes.c_int64,                 # homes, qfp, n
        ctypes.c_int64, ctypes.c_int64,               # stride, chunk_rows
        ctypes.c_int64, ctypes.c_int64,               # n_chunks, cap
        _U16P, _U16P, _U8P,                           # bins out
        _I64P, _I64P,                                 # chunk_of, rank_of out
    ]


def load_scatter() -> Optional[ctypes.CDLL]:
    """Native stream front/back end (scatter_chunk + resolve_slots/emit_hits)."""
    return _load("scatter", "KMER_NO_NATIVE_SCATTER", _bind_scatter)


def _bind_grouping(lib) -> None:
    fn = lib.group_batch
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        _I64P, _I32P, _I32P, _I32P, _F32P,           # hit columns
        _I64P, ctypes.c_int64,                        # bounds
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32,                               # params
        _I64P, _I64P, _I64P, _I32P, _I32P, _F32P,     # call records
        _I32P, _I32P, _I32P,                          # nupd + updates
        ctypes.c_int64, ctypes.c_int64,               # capacities
    ]
    fn = lib.jweight
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_float, _U8P]
    fn = lib.emit_report
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        _U8P, _I64P, _I64P,                           # ids blob/off, seq_len
        ctypes.c_int64, ctypes.c_int32, _I64P,        # n_seq, frames, batch
        _I64P, _I64P, _I64P, _I32P, _I32P, _F32P,     # call_off + call cols
        _I64P, _I32P, _I32P,                          # upd_base + updates
        _U8P, _I64P,                                  # function blob/off
        _U8P, ctypes.c_int64,                         # out buffer, capacity
    ]


def load_grouping() -> Optional[ctypes.CDLL]:
    """Native batch grouping core; None without g++."""
    return _load("grouping", "KMER_NO_NATIVE_GROUPING", _bind_grouping)


def _bind_fasta(lib) -> None:
    fn = lib.parse_fasta
    fn.restype = ctypes.c_int64
    fn.argtypes = [_U8P, ctypes.c_int64, _I64P, ctypes.c_int64, _U8P, _I64P]


def load_fasta() -> Optional[ctypes.CDLL]:
    """Native bulk FASTA parser; None without g++."""
    return _load("fasta", "KMER_NO_NATIVE_FASTA", _bind_fasta)


def bin_queries_native(homes: np.ndarray, q_fp: np.ndarray, stride: int,
                       chunk_rows: int, n_chunks: int, cap: int):
    """Threaded bin router for the chunked probe (scatter.cpp
    bin_queries): (qfp_b, row_b, off_b, chunk_of, rank_of), bit-identical
    to XlaLookup._bin_queries' numpy twin. None without the toolchain
    (or under KMER_NO_NATIVE_SCATTER)."""
    lib = load_scatter()
    if lib is None:
        return None
    n = len(homes)
    qfp_b = np.zeros((n_chunks, cap), np.uint16)
    row_b = np.zeros((n_chunks, cap), np.uint16)
    off_b = np.zeros((n_chunks, cap), np.uint8)
    chunk_of = np.empty(n, np.int64)
    rank_of = np.empty(n, np.int64)
    lib.bin_queries(np.ascontiguousarray(homes, np.int32),
                    np.ascontiguousarray(q_fp, np.uint16), n,
                    stride, chunk_rows, n_chunks, cap,
                    qfp_b.reshape(-1), row_b.reshape(-1), off_b.reshape(-1),
                    chunk_of, rank_of)
    return qfp_b, row_b, off_b, chunk_of, rank_of
