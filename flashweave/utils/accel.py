"""Execution-path choice: the accelerator path or the float64 parity path.

Every module that has a fast device path asks :func:`on_accelerator` once
per call site instead of testing the backend's name.  On an accelerator the
run takes the device path: two-pass device extraction of the univariate
pairs, one shared int8 (discrete) or float32 (continuous) table upload, the
on-device decision digests and the turbo-window kernel.  On the CPU the run
keeps the float64 parity path, whose results match the reference
bit-for-bit; the tests force the device path there through each module's
``FORCE_*`` hook.

Pallas kernels never infer interpret mode from the backend: interpret mode
is an explicit argument that only the tests pass.
"""

from __future__ import annotations

import jax


def on_accelerator(force: bool = False) -> bool:
    """True when the run takes the accelerator path.

    ``force`` is the calling module's test hook: it selects the accelerator
    path on the CPU so the tests exercise it with the same programs."""
    return bool(force) or jax.default_backend() != "cpu"
