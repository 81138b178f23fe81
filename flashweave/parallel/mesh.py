"""Device-mesh helpers.

The reference scales via Julia Distributed worker processes sharing (or
copying) the data matrix (reference: src/interleaved.jl, README.md:185-216).
The JAX equivalent is a jax.sharding.Mesh:

- the OTU matrix is REPLICATED across devices (it is small relative to HBM:
  even 50k samples x 100k vars int8 is 5 GB),
- the univariate pair-matrix work is sharded over the variable axis, so each
  device computes a column slab of every all-pairs moment/contingency matmul
  and XLA inserts any needed collectives over NVLink,
- conditional-test batches are sharded over the test (batch) axis --
  data-parallel across devices with zero communication, the merge being the
  host-side gather of per-test statistics.

All sharded compute paths are expressed EXPLICITLY with jax.shard_map over
the mesh's 'd' axis (ops/univariate.py, ops/condtests.py); the helpers here
only build the mesh and place replicated inputs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def get_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    return Mesh(np.array(devs[:n]), ("d",))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def put_replicated(x, mesh: Mesh):
    """Place a host array replicated over the mesh, multi-process safe.

    Single-process: plain device_put.  Multi-process (the mesh spans hosts):
    every process holds the full array locally, so the replicated global
    Array assembles from process-local data without any transfer between
    hosts."""
    sh = replicated(mesh)
    if jax.process_count() == 1:
        return jax.device_put(x, sh)
    return jax.make_array_from_process_local_data(sh, np.asarray(x))


def col_sharded(mesh: Mesh) -> NamedSharding:
    """(n, p) arrays sharded over the variable axis."""
    return NamedSharding(mesh, P(None, "d"))


def batch_sharded(mesh: Mesh) -> NamedSharding:
    """Test batches sharded over the leading axis."""
    return NamedSharding(mesh, P("d"))


def bcast_scalar_from_rank0(mesh: Mesh, value: float) -> float:
    """Every process passes its local value; all receive PROCESS 0's.

    Used for the multi-process deterministic clock: wall-clock decisions
    (convergence, time-limit checkpoints) must be identical on every process
    or their shard_map request streams fork and the collectives desync
    (reference contract: src/interleaved.jl:203-230 runs convergence on the
    single master).  One tiny psum per scheduler round; device 0 always
    belongs to process 0."""
    import jax.numpy as jnp
    from jax import lax
    from functools import lru_cache

    fn = _bcast_fn(mesh)
    ndev_loc = len([d for d in mesh.devices.flat
                    if d.process_index == jax.process_index()])
    local = np.full(ndev_loc, float(value))
    if jax.process_count() == 1:
        x = jax.device_put(local, NamedSharding(mesh, P("d")))
    else:
        x = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P("d")), local)
    return float(fn(x))


def _bcast_fn(mesh: Mesh):
    import jax.numpy as jnp
    from jax import lax

    fn = _BCAST_CACHE.get(mesh)
    if fn is None:
        def body(x):
            v = jnp.where(jax.lax.axis_index("d") == 0, x[0], 0.0)
            return lax.psum(v, "d")

        fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("d"),
                                   out_specs=P(), check_vma=False))
        _BCAST_CACHE[mesh] = fn
    return fn


_BCAST_CACHE: dict = {}


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int,
                    value=0) -> np.ndarray:
    size = x.shape[axis]
    pad = (-size) % multiple
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=value)
