"""The control, the reference put in the program's place one precision
below the configuration's, comes out not correct under each cell's limits
(calibrate.py reads it at the cells' own sizes on the card; these run it at
sizes a test run holds)."""

import pytest
import torch

from perfbench import calibrate
from perfbench.harness.compare import judge
from perfbench.tests.conftest import small_cell


def test_bfloat16_control_fails_the_analytic_fit():
    cell = small_cell("scene2_train_4k", 192, 108)
    numbers, _ = calibrate.train_control(cell, 2**31 + 5, torch.device("cpu"))
    assert not judge(numbers, cell.limits)[0], numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["siren_w256_train_512",
                                  "siren_w256_serve_512"])
def test_tf32_control_fails_the_neural_cells(card, name):
    cell = small_cell(name, 256, 256)
    if cell.traffic["kind"] == "train_fit":
        numbers, _ = calibrate.train_control(cell, 2**31 + 5, card)
    else:
        numbers = calibrate.serve_control(cell, 2**31 + 5, card, 4)
    assert not judge(numbers, cell.limits)[0], numbers


@pytest.mark.parametrize("fault", ["half", "shift", "reset"])
def test_planted_faults_fail_the_analytic_fit(fault):
    cell = small_cell("scene2_train_4k", 192, 108)
    numbers, _ = calibrate.train_control(cell, 2**31 + 5,
                                         torch.device("cpu"), fault)
    assert not judge(numbers, cell.limits)[0], numbers
