"""Entry-point behaviour: the compile-cache placement, and removed or
misspelt backends and probe layouts rejected as usage errors."""
import os

import jax
import pytest

import kmergutsjava_tpu
from kmergutsjava_tpu.cli import main as cli_main
from kmergutsjava_tpu.formats.table_tools import (signatures_from_proteins,
                                                  write_data_dir)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert kmergutsjava_tpu.compile_cache_dir() == os.path.join(
        REPO, ".jax_cache")


@pytest.mark.parametrize("env", [True, False])
def test_compile_cache_placement_on_a_device(env, monkeypatch, tmp_path):
    """On an accelerator the cache caches every executable; its directory
    is the checkout's unless $JAX_COMPILATION_CACHE_DIR names one, which
    JAX reads itself (no other directory is set)."""
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(kmergutsjava_tpu, "_REPO", str(tmp_path))
    if env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "e"))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = kmergutsjava_tpu.enable_compile_cache()
    want = str(tmp_path / "e") if env else str(tmp_path / ".jax_cache")
    assert path == want == kmergutsjava_tpu.compile_cache_dir()
    assert updates.pop("jax_persistent_cache_min_compile_time_secs") == 0.0
    assert updates == ({} if env else {"jax_compilation_cache_dir": want})


def test_compile_cache_stays_off_on_cpu(monkeypatch):
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert kmergutsjava_tpu.enable_compile_cache() is None
    assert updates == {}


@pytest.fixture
def data_dir(tmp_path):
    d = tmp_path / "d"
    write_data_dir(str(d), signatures_from_proteins(
        [("ACDEFGHIKLMNPQRSTVWY", 0, 3)]), ["funcA"])
    return str(d)


@pytest.mark.parametrize("backend", ["pallas", "tilejoin", "Stream", ""])
def test_unknown_backend_is_a_usage_error(backend, data_dir, capsys):
    assert cli_main(["-a", "-D", data_dir, "--backend", backend]) == 2
    assert "unknown backend" in capsys.readouterr().out


@pytest.mark.parametrize("impl", ["tilejoin", "mxu"])
def test_unknown_probe_impl_is_a_usage_error(impl, data_dir, capsys,
                                             monkeypatch):
    monkeypatch.setenv("KMER_PROBE_IMPL", impl)
    assert cli_main(["-a", "-D", data_dir]) == 2
    assert "KMER_PROBE_IMPL" in capsys.readouterr().out


def test_native_status_names_why_a_library_is_off(monkeypatch):
    from kmergutsjava_tpu.utils import native

    monkeypatch.setenv("KMER_NO_NATIVE_FASTA", "1")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_errors", {})
    assert native.load_fasta() is None
    assert native.load_grouping() is not None
    status = native.native_status()
    assert status["fasta"] == "disabled by KMER_NO_NATIVE_FASTA"
    assert status["grouping"] == "loaded"
