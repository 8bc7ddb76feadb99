"""Two more cases of the presets at full width against JAX on the CPU,
with tests/test_torch_presets.py's harness and bars (a file of its own,
so that the two spread over two workers):

- A bare tone 300 Hz above the dial, nothing else, for the 3 kHz presets
  SSB, NCW and HSMS.  Without noise to hide it, the rounding of mix1's
  fractional-bin ramp reached the baseband amplified (mix2 divides by the
  mix1 window, small at the band edges): 2.4e-4-3.8e-4 against JAX until
  the ramp took its sums in XLA's order (ROADMAP queue 3).
- ``fft1_variant="pallas"`` for every preset whose fft1 has at most 4,096
  points: on the CPU the port's kernel wrapper runs its plain version and
  the JAX package its Pallas kernel in interpret mode.  TXTEST and RADAR
  give SSB's parameters, so SSB's case stands for them; WCW (8,192) and
  QRSS (16,384) have no fused kernel in either package.
"""

import pytest

from linrad_tpu import RxMode
from test_torch_presets import (FIELDS, check_afc, check_field,
                                check_final_state, run_pair)

TONE = ["SSB", "NCW", "HSMS"]
PALLAS = ["HSMS", "SSB", "FM", "AM", "NCW"]
CASES = [f"{m}-tone" for m in TONE] + [f"{m}-pallas" for m in PALLAS]


@pytest.fixture(scope="module", params=CASES)
def runs(request):
    mode, case = request.param.split("-")
    if case == "tone":
        return run_pair(RxMode[mode], "tone")
    return run_pair(RxMode[mode], fft1_variant="pallas")


def test_geometry(runs):
    geo = runs["trx"].geo
    if runs["p"].fft1_variant == "pallas":
        assert geo.fft1_size <= 4096
    assert geo.fft1_size == runs["jrx"].geo.fft1_size


@pytest.mark.parametrize("field", FIELDS)
def test_field_parity(runs, field):
    check_field(runs, field)


def test_final_state(runs):
    check_final_state(runs)
    if runs["p"].afc_enable:
        check_afc(runs)
