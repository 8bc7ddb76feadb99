"""The cells on the card at their full size, briefly: the port correct
against the reference, the control not.  Skipped without a CUDA device."""

import time

import pytest

from rxbench import core
from rxbench.tests.tiny import CELLS, SEED


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, card):
    result, _lines, err = core.run_cell(cell, SEED, 1.0, False, card,
                                        time.perf_counter())
    assert result["correct"], err
    assert result["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell, card):
    result, _lines, err = core.run_cell(cell, SEED + 1, 1.0, False, card,
                                        time.perf_counter(),
                                        program={"fft1_variant": "mxu_bf16"})
    assert not result["correct"], err
