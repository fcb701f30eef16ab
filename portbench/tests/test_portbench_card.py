"""On the card: the control at a cell's own size comes out not correct.
Run on a machine with an NVIDIA card, from the root of the checkout:
``python -m pytest -m cuda portbench/tests/test_portbench_card.py``."""
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["grid128_1m.random", "city9k_250k.sp"])
def test_control_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from portbench.control import control_readings

    out = control_readings(REPO, cell, 2 ** 31 + 3, torch.device("cuda"))
    assert not out["correct"]
    assert out["start_mismatch"]["value"] > 0
