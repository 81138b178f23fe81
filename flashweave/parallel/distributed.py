"""Multi-process (multi-host) runtime plumbing.

The reference scales to remote workers on clusters via Julia Distributed /
ClusterManagers (reference: README.md:185-216, src/interleaved.jl:90-93).
The JAX equivalent is one Python process per host attached to the
same JAX distributed runtime: after ``jax.distributed.initialize`` the
global ``jax.devices()`` spans every host, ``parallel.mesh.get_mesh`` builds
the global mesh from it, and the SAME ``shard_map`` programs used
single-host run unchanged -- the collective layout crosses hosts cheaply by
construction (the univariate pass psums tiny count tables and all_gathers
only compacted candidate buffers; conditional batches are embarrassingly
parallel with a final result all_gather).

Launch contract (mirrors the standard JAX multi-process recipe): every
process runs the same program with

  FLASHWEAVE_COORDINATOR   host:port of process 0
  FLASHWEAVE_NUM_PROCESSES total process count
  FLASHWEAVE_PROCESS_ID    this process's rank

and calls :func:`initialize_from_env` before any other JAX use.  Where a
cluster environment lets JAX infer everything, plain
``jax.distributed.initialize()`` (no env) works too.  Validated by ``tests/test_distributed.py``, which
launches two CPU processes with gloo cross-process collectives and asserts
univariate + conditional parity against the single-process result.
"""

from __future__ import annotations

import os


def initialize_from_env() -> bool:
    """Join the JAX distributed runtime if launch env vars are present.

    Returns True when multi-process mode was initialized.  Must be called
    before the first jax array/device operation in the process.
    """
    coord = os.environ.get("FLASHWEAVE_COORDINATOR")
    if not coord:
        return False
    import jax

    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(os.environ["FLASHWEAVE_NUM_PROCESSES"]),
        process_id=int(os.environ["FLASHWEAVE_PROCESS_ID"]),
    )
    return True


def process_index() -> int:
    import jax

    return jax.process_index()


def is_primary() -> bool:
    """True on the process that should perform I/O / result assembly."""
    import jax

    return jax.process_index() == 0
