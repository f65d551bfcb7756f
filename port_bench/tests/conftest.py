"""CPU tests of the benchmark: run with

    python -m pytest -q port_bench/tests

from the root of the repository.  They drive the program with
``compute_device="cpu"`` (the kernels' plain versions) at tiny sizes.
Tests that need the card carry the ``card`` marker and skip, deciding in
a fixture, where torch sees no CUDA device.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch sees none")


# tiny sizes for the CPU: a store at a 1 MiB byte scale (vlsm's memtable
# 5,242 keys, rocksdb's 5,242 too), so that memtables roll and chains run
SCALE = 1 << 20
TINY = {
    "replay": {"n_load": 30_000, "run_ops": 12_000},
    "served": {"n_load": 24_000, "pool_batches": 6, "batch_ops": 2_000,
               "load_batch": 7_000, "warm_batches": 2},
}


@pytest.fixture
def tiny():
    return TINY, SCALE
