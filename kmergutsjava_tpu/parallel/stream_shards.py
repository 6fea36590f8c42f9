"""Multi-device dense stream lookup: superblock-sharded plane + query tiles.

Scaling of the zero-gather stream probe (lookup/stream.py; the
reference's lookup loop analog, KmerGutsJava.java:944-1034).

The dense-tile formulation routes every query to its home slot at scatter
time, so sharding the fingerprint plane by superblock range simultaneously
shards the query tiles: plane shard i pairs with tile shard i and the probe
needs NO collectives at all (contrast routed_lookup.py, which must
all_to_all the query stream to its owner shard). Per-row probe halos are
built into the plane layout host-side, so there is no cross-shard halo
exchange either. Every shard streams only its slice, so the device work
splits evenly over the table axis; the only multi-device cost is
scattering tile shards host->device.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..formats.kmer_table import KmerTable
from ..lookup.stream import StreamLookup, stream_probe_blocks
from .mesh import TABLE_AXIS


def make_stream_mesh(n_shards: int) -> jax.sharding.Mesh:
    devs = jax.devices()
    if n_shards > len(devs):
        raise ValueError(f"stream mesh needs {n_shards} devices, "
                         f"{len(devs)} available")
    devs = np.array(devs[:n_shards])
    return jax.sharding.Mesh(devs, (TABLE_AXIS,))


class StreamShardedLookup(StreamLookup):
    """Stream-probe lookup with the plane and tiles sharded over a 1-D
    ``table`` mesh. Same exact-result contract as the single-chip class
    (host verification + exact fallback are inherited unchanged)."""

    def __init__(self, table: KmerTable, mesh: Optional[jax.sharding.Mesh]
                 = None, n_shards: Optional[int] = None, **kw):
        if mesh is None:
            mesh = make_stream_mesh(n_shards or len(jax.devices()))
        if TABLE_AXIS not in mesh.shape:
            raise ValueError(f"mesh must carry a '{TABLE_AXIS}' axis")
        self.mesh = mesh
        self.n_shards = int(mesh.shape[TABLE_AXIS])
        self._spec = P(TABLE_AXIS)
        super().__init__(table, nsuper_multiple=self.n_shards, **kw)

        def local_probe(fp_loc, tiles_loc):
            # one probe per shard over its local superblocks; no
            # collectives — tile shard i holds exactly the queries whose
            # home slots live in plane shard i
            return stream_probe_blocks(fp_loc, tiles_loc, self.w,
                                       self.channels)

        self._step = jax.jit(jax.shard_map(
            local_probe, mesh=mesh,
            in_specs=(self._spec, self._spec), out_specs=self._spec))

    def _place_plane(self, fp_host: np.ndarray, device):
        return jax.device_put(
            fp_host, NamedSharding(self.mesh, self._spec))

    def _probe(self, qfp_tiles: np.ndarray):
        tiles = jax.device_put(
            qfp_tiles, NamedSharding(self.mesh, self._spec))
        return self._step(self.fp_blocks, tiles)
