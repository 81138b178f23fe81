"""FlashWeave in JAX: microbial association-network inference on accelerators.

A from-scratch JAX/XLA re-design of the capabilities of FlashWeave.jl
(reference layout: src/FlashWeave.jl:34-41 exports learn_network,
normalize_data, save_network, load_network, load_data, graph,
meta_variable_mask).

Architecture (batched, not a port):
- contingency tables      -> one-hot batched matmuls on the tensor cores
- (partial) correlations  -> (masked-)moment matmuls + small DP
- HITON-PC search         -> host coroutines emitting fixed-shape device
                             batches of conditional-independence tests
- parallelism             -> jax.sharding over a device mesh (tests/pair-tiles
                             sharded, data replicated), not worker processes
"""

from .types import (
    TestResult,
    HitonState,
    LGLResult,
    FWResult,
    Graph,
    graph,
    meta_variable_mask,
    parameters,
)

__version__ = "0.1.0"

_LAZY = {
    "normalize_data": ("flashweave.preprocessing", "normalize_data"),
    "load_data": ("flashweave.io", "load_data"),
    "save_network": ("flashweave.io", "save_network"),
    "load_network": ("flashweave.io", "load_network"),
    "learn_network": ("flashweave.learning.network", "learn_network"),
}


def __getattr__(name):
    # defer heavy submodule imports (jax tracing setup) until first use
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "learn_network",
    "normalize_data",
    "save_network",
    "load_network",
    "load_data",
    "graph",
    "meta_variable_mask",
    "parameters",
    "TestResult",
    "HitonState",
    "LGLResult",
    "FWResult",
    "Graph",
]
