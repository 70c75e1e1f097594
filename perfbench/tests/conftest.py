"""Shared fixtures: a cell cut to a size the CPU can run, and the card."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small_cell(name, width, height):
    """The cell ``name`` at ``width`` × ``height`` (the test sizes; the
    benchmark's runs keep the configuration's)."""
    from perfbench.harness.spec import load_cell

    cell = copy.deepcopy(load_cell(name))
    cell.config["render"].update(width=width, height=height)
    return cell


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    """One torch thread per test process: the runs here are many small
    operations, which several workers' thread pools slow many times over."""
    import torch

    torch.set_num_threads(1)


@pytest.fixture
def card():
    """Skips a test without a CUDA device (decided here, when the test
    runs, never while the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); run on the card")
    return torch.device("cuda")
