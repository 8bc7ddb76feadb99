"""The port's twins of examples/{demo_rx,demo_multirx,demo_tx,serve_rx,
parity_report}.py (linrad_tpu_torch/examples/), each run once on
device="cpu" at the cut geometry (``tiny``: fft1 256, 1,024 samples per
step, a short signal).
The twins import linrad_tpu_torch only (tests/test_torch_no_jax.py); the
JAX package's examples are not run here.
"""

import numpy as np
import pytest

from linrad_tpu_torch.examples import (demo_multirx, demo_rx, demo_tx,
                                       parity_report, serve_rx)


def test_demo_rx(tmp_path):
    res = demo_rx.main(str(tmp_path), device="cpu", tiny=True)
    assert res["text_ml"] == res["expected"] == "TEST"
    assert res["steps"] > 0
    assert (tmp_path / "audio.wav").stat().st_size > 44
    assert (tmp_path / "waterfall.pgm").read_bytes()[:2] == b"P5"


def test_demo_multirx():
    res = demo_multirx.main(device="cpu", tiny=True)
    k, s, c = res["audio_shape"]
    assert (k, c) == (3, 1) and s > 0
    assert all(np.isfinite(res["peaks_hz"]))


def test_demo_tx(tmp_path):
    res = demo_tx.main(str(tmp_path), device="cpu", tiny=True)
    assert res["dac_samples"] == 7 * 4 * 1024     # 7 whole mic blocks
    assert res["imd3_db"] < -40 and 0.2 < res["duty"] < 0.6
    assert (tmp_path / "ssb_iq.wav").stat().st_size > 44


def test_serve_rx():
    """The GUI saw every step of the drifting carrier, and the AFC ran."""
    res = serve_rx.main(0, device="cpu", tiny=True)
    assert res["steps"] == 40 and res["status"]["steps"] == 40
    assert res["status"]["audio_samples"] > 0
    assert res["afc_status"] is not None


def test_parity_report(tmp_path):
    """The five configurations' rows, written as markdown.  At the cut
    geometry the blanker's noise floor (which starts 23 dB up and follows
    with a time constant of a second) has not come down within the six
    10 ms steps of configuration 3, so its row is only reported here;
    chip_smoke.py phase 20 runs the report at full width, where all five
    must pass."""
    out = tmp_path / "report.md"
    res = parity_report.main(str(out), device="cpu", tiny=True)
    assert sorted(res["passed"]) == [1, 2, 3, 4, 5]
    assert all(res["passed"][k] for k in (1, 2, 4, 5)), res["lines"]
    text = out.read_text()
    assert text.startswith("# BASELINE config parity report")
    assert "decoded 'TEST'" in text and text.count("| PASS |") >= 4


def test_twins_refuse_a_missing_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        demo_multirx.main(tiny=True)
