"""linrad_tpu_torch never imports jax: the machine with the card has no
JAX.  Checked in a fresh interpreter, since this test process has jax
loaded already (tests/conftest.py)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

MODULES = [
    "linrad_tpu_torch",
    "linrad_tpu_torch.convert",
    "linrad_tpu_torch.ops.agc",
    "linrad_tpu_torch.ops.blanker",
    "linrad_tpu_torch.ops.demod",
    "linrad_tpu_torch.ops.fft",
    "linrad_tpu_torch.ops.fft1",
    "linrad_tpu_torch.ops.fft2",
    "linrad_tpu_torch.ops.fft3",
    "linrad_tpu_torch.ops.framing",
    "linrad_tpu_torch.ops.fused_fft1",
    "linrad_tpu_torch.ops.mix1",
    "linrad_tpu_torch.ops.mix2",
    "linrad_tpu_torch.ops.sellim",
    "linrad_tpu_torch.ops.timf2",
    "linrad_tpu_torch.pipeline.chain",
    "linrad_tpu_torch.pipeline.control",
    "linrad_tpu_torch.pipeline.receiver",
    "linrad_tpu_torch.utils.scanops",
    "linrad_tpu_torch.utils.segments",
    "linrad_tpu_torch.weak.pol",
    # numpy modules of the JAX package that the port shares by import
    "linrad_tpu.weak.afc",
    "linrad_tpu.utils.llsq",
]


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("module", MODULES)
def test_module_does_not_import_jax(module):
    proc = _run(f"import sys, importlib; importlib.import_module({module!r});"
                f"print(sorted(m for m in sys.modules if m == 'jax' "
                f"or m.startswith('jax.')))")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_cpu_receiver_step_does_not_import_jax():
    """Build a tiny Receiver on the CPU and run one step, jax-free."""
    proc = _run(
        "import sys, numpy as np\n"
        "from linrad_tpu_torch import flagship_params\n"
        "from linrad_tpu_torch.pipeline.receiver import Receiver\n"
        "rx = Receiver(flagship_params(tiny=True), device='cpu')\n"
        "rx.tune(1000.0)\n"
        "out = rx.process_block(np.zeros((rx.geo.samples_per_step, 1),"
        " np.complex64))\n"
        "assert out.audio.shape == (rx.geo.baseband_samples_per_step, 1)\n"
        "print('jax' in sys.modules)\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"


def test_cpu_eme_receiver_does_not_import_jax():
    """The tiny EME Receiver (two channels, adaptive polarization,
    coherent detection, AFC) runs 5 steps, so the AFC acquires, jax-free."""
    proc = _run(
        "import sys, numpy as np\n"
        "from linrad_tpu import RxMode, preset\n"
        "from linrad_tpu_torch.pipeline.receiver import Receiver\n"
        "p = preset(RxMode.WCW, rx_ad_speed=48_000, rx_rf_channels=2,"
        " pol_adapt_enable=True, fft1_variant='pallas', fft1_n_override=8,"
        " target_fft1_frames_per_step=8, fft3_n=6, max_pulses_per_block=8)\n"
        "rx = Receiver(p, device='cpu')\n"
        "rx.tune(1000.0)\n"
        "rng = np.random.default_rng(0)\n"
        "n = 5 * rx.geo.samples_per_step\n"
        "iq = (rng.normal(size=(n, 2)) + 1j * rng.normal(size=(n, 2)))"
        ".astype(np.complex64)\n"
        "outs = list(rx.run(iq))\n"
        "assert len(outs) == 5 and rx.control.host_reads == 5\n"
        "assert outs[-1].audio.shape == (rx.geo.baseband_samples_per_step, 1)\n"
        "print('jax' in sys.modules)\n")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"
