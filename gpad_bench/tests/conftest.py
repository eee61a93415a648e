"""The benchmark's own tests, kept apart from the repo's ``tests/``:

    python -m pytest gpad_bench/tests -q -p no:cacheprovider

Tests marked ``cuda`` need a card and skip without one, deciding inside
the test. They import no jax, so they run on the machine with the card.
"""

import sys

import pytest
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped without one")


# A cell's run on the CPU at a size a test can hold: the driver, the window
# and the check against the reference as on the card, the look for a card
# skipped (run.py alone makes it).
SMALL = {
    "battery_n3_N10.fleet": {"batch": 64, "keep_calls": 2},
    "battery_n30_N30.fleet": {"batch": 8, "keep_calls": 2},
    "battery_n30_N30.fleet_b256": {"batch": 8, "keep_calls": 2},
    "battery_n30_N30.serve": {"plants": 4, "check_plants": 4},
}


def drive(cell_name: str, seconds: float = 0.4, seed: int = 2**31 + 11,
          **overrides):
    import time

    import torch

    from gpad_bench import harness

    return harness.drive(harness.load_cell(cell_name), seed, seconds, False,
                         torch.device("cpu"), time.perf_counter(),
                         **{**SMALL.get(cell_name, {}), **overrides})


@pytest.fixture
def run_cpu():
    return drive
