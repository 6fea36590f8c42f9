"""Signature-k-mer annotation engine on JAX.

A from-scratch JAX/XLA framework with the capabilities of the reference
engine (rsutormin/KmerGutsJava): FASTA -> 6-frame translation ->
amino-acid 8-mer encoding -> signature-table lookup -> per-sequence function
CALLs and OTU counts, bit-identical to the reference's text report.
"""
import os as _os

import jax as _jax

# Encoded 8-mers span [0, 20^8) which exceeds int32; device-side encode and
# home-slot computation use int64.
_jax.config.update("jax_enable_x64", True)

# The checkout this package runs from: the default compile-cache location.
_REPO = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """Where the persistent compilation cache lives: $JAX_COMPILATION_CACHE_DIR
    when set, else one fixed directory in the checkout (the path is part of
    the cache key, so it must not move between runs)."""
    return (_os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or _os.path.join(_REPO, ".jax_cache"))


def enable_compile_cache():
    """Enable the persistent compilation cache for accelerator runs and
    return its directory (None when left off). Call it before the first
    compile.

    The cache lives in ``compile_cache_dir()``: with $JAX_COMPILATION_CACHE_DIR
    set, JAX already uses that directory and no other is set here. Every
    executable is cached, however fast it compiled, so a second run of the
    same program compiles nothing. Deliberately NOT enabled for
    CPU-backend runs: XLA:CPU AOT artifacts bake in host ISA feature flags
    and reloading them across heterogeneous hosts risks SIGILL.
    """
    if _jax.default_backend() == "cpu":
        return None
    path = compile_cache_dir()
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _os.makedirs(path, exist_ok=True)
        _jax.config.update("jax_compilation_cache_dir", path)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path


__version__ = "0.1.0"

# Public library surface (lazy: importing the package must stay cheap and
# must not pull jax.numpy/device state before the caller configures jax).
# See docs/api.md for usage.
_EXPORTS = {
    "Engine": ("kmergutsjava_tpu.models.pipeline", "Engine"),
    "EngineConfig": ("kmergutsjava_tpu.config", "EngineConfig"),
    "build_table": ("kmergutsjava_tpu.formats.kmer_table", "build_table"),
    "read_table": ("kmergutsjava_tpu.formats.kmer_table", "read_table"),
    "write_table": ("kmergutsjava_tpu.formats.kmer_table", "write_table"),
    "KmerTable": ("kmergutsjava_tpu.formats.kmer_table", "KmerTable"),
    "read_fasta": ("kmergutsjava_tpu.formats.fasta", "read_fasta"),
    "FastaRecord": ("kmergutsjava_tpu.formats.fasta", "FastaRecord"),
    "load_function_index": ("kmergutsjava_tpu.formats.function_index",
                            "load_function_index"),
    "signatures_from_proteins": ("kmergutsjava_tpu.formats.table_tools",
                                 "signatures_from_proteins"),
    "write_data_dir": ("kmergutsjava_tpu.formats.table_tools",
                       "write_data_dir"),
}

__all__ = sorted(_EXPORTS) + ["compile_cache_dir", "enable_compile_cache"]


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(target[0]), target[1])
    globals()[name] = value  # cache for subsequent lookups
    return value
