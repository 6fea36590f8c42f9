"""Typed engine configuration.

One dataclass covering the reference's CLI surface (ref
KmerGutsJava.java:560-654: flags -a -d -m -M -O -g -D -q -o -t -l) plus
device extensions (backend selection, probe/chunk sizing, mesh shape). The
reference's -t/-l flags are unusable there due to a switch fall-through
defect (ref :605-610); here they work as documented.
"""
from __future__ import annotations

import tempfile
from dataclasses import dataclass
from typing import Optional, Tuple

# lookup backends accepted by EngineConfig.backend (and --backend)
BACKENDS = ("auto", "parity", "xla", "stream", "spmd", "sharded", "routed",
            "replicated")


@dataclass
class EngineConfig:
    # reference-equivalent parameters (ref :102-109)
    aa: bool = False
    order_constraint: bool = False
    min_hits: int = 5
    min_weighted_hits: int = 0
    max_gap: int = 200
    debug: bool = False
    input_size_limit: int = 20 * 1000 * 1000  # max query k-mers in RAM
    temp_dir: Optional[str] = None

    # device extensions
    # lookup backend, one of BACKENDS: "auto" (default) picks stream vs
    # xla from the estimated query count vs table size — both are exact,
    # a wrong guess only costs speed
    backend: str = "auto"
    # encode/translate implementation for the feeder pipeline: "native"
    # (C++ feeder via ctypes, default; numpy fallback if no toolchain),
    # "numpy" (vectorized host twin), or "jax" (the jitted device ops;
    # canonical for on-device pipelines)
    prepare_impl: str = "native"
    # call-grouping implementation: "host" (exact machine + fast paths,
    # default) or "scan" (jitted lax.scan over container batches — the
    # device-side formulation; falls back to host for debug / min_hits < 2)
    grouping_impl: str = "host"
    # queries per device dispatch; None = the default (1<<19). An
    # explicit value is always honored as passed.
    lookup_chunk: Optional[int] = None
    probe_window: Optional[int] = None  # override table-derived window
    length_bucket_base: int = 256  # smallest padded batch length for aa mode
    mesh_shape: Optional[Tuple[int, int]] = None  # (data, table) shards
    profile_dir: Optional[str] = None  # jax.profiler trace output dir
    # home-sort queries before probing (None = auto: large tables only)
    # and whether to run that sort on-device (lax.sort_key_val) instead of
    # a feeder-thread argsort
    sort_chunks: Optional[bool] = None
    device_sort: Optional[bool] = None

    def resolved_temp_dir(self) -> str:
        return self.temp_dir if self.temp_dir is not None else tempfile.gettempdir()
