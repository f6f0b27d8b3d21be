"""On the card: each cell runs once at a short window and comes out
correct (``python -m pytest -m gpu benchmark/tests`` from the repository
root, on a machine with an H100)."""

import pytest
import torch

from benchmark import harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: each cell runs its CUDA kernels")
    harness.set_cache_dirs()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["render.blender1080", "edit.dge20"])
def test_cell_runs_correct_on_the_card(card, cell):
    out = harness.run_cell(harness.load_cell(cell, 2 ** 31 + 99, 2.0, False,
                                             "cuda"))
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
