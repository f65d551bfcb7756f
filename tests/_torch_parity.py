"""Shared fixture for the port's parity tests (``tests/test_torch_*.py``).

The reference keeps its merge and LevelIndex backends in module-level
switches (``repro.core.merge.set_backend``, ``repro.core.level_index.
set_backend``).  Test files that exercise its jnp or pallas tiers can leave
a switch there when they fail midway, and those tiers do not run on JAX
0.9.0.  The parity tests compare against the numpy tiers, so they set those
for the duration of each test and then restore whatever was set before:
every other test of the same process sees the switches as it would without
the port's tests.
"""

import pytest

import repro.core.level_index as ref_level_index
import repro.core.merge as ref_merge


@pytest.fixture
def reference_numpy_tiers():
    saved = (ref_merge.get_backend(), ref_level_index.get_backend())
    ref_merge.set_backend("numpy")
    ref_level_index.set_backend("numpy")
    try:
        yield
    finally:
        ref_merge.set_backend(saved[0])
        ref_level_index.set_backend(saved[1])
