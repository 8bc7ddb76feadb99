"""The port's time-sharded receiver against the JAX package's, continued
(harness and bars: tests/test_torch_sharded.py): the AFC on per-frame
integer tuning and on coherent (bins, frac, slope) tuning, the I/Q image
correction, real input and mixer mode 2.  The AFC runs 7 steps of
tests/test_sharded.py's drifting carrier: it acquires from the first 4
and then steers the sharded per-frame steps; its status and the tuning it
hands the step must be the same on both sides after every step."""

import pytest

from test_torch_sharded import (FIELDS, check_field, check_not_vacuous,
                                check_state, run_both)

HERE = ["afc-frames", "afc-coherent", "iq-corr", "real-input",
        "mixer-mode-2"]


@pytest.fixture(scope="module", params=HERE)
def runs(request):
    return run_both(request.param)


@pytest.mark.parametrize("field", FIELDS)
def test_field_against_jax(runs, field):
    check_field(runs, field)


def test_final_state_against_jax(runs):
    check_state(runs)


def test_comparison_not_vacuous(runs):
    check_not_vacuous(runs)


def test_afc_steers_the_sharded_steps(runs):
    """The AFC configurations reach the per-frame paths: integer frame
    bins, and with afc_coherent the (frac, slope) ramps."""
    if not runs["name"].startswith("afc"):
        assert runs["afc"] == []
        return
    trx = runs["trx"]
    statuses = [s[1] for s in runs["afc"]]
    assert statuses[-1] in (2, 3), statuses
    assert trx._tune_bin.shape == (trx.geo.fftx_frames_per_step,)
    assert (trx._tune_slope is not None) == (runs["name"] == "afc-coherent")
