"""linrad_tpu_torch never imports jax, nor any module of the JAX package
linrad_tpu: the machine with the card has no JAX, and the port keeps its
own copies of the configuration modules.  Checked in a fresh interpreter,
since this test process has jax loaded already (tests/conftest.py), and
statically over the port's sources."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

MODULES = [
    "linrad_tpu_torch",
    "linrad_tpu_torch.calibration",
    "linrad_tpu_torch.convert",
    "linrad_tpu_torch.errors",
    "linrad_tpu_torch.geometry",
    "linrad_tpu_torch.io.rawfile",
    "linrad_tpu_torch.io.siggen",
    "linrad_tpu_torch.io.wav",
    "linrad_tpu_torch.params",
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
    "linrad_tpu_torch.ops.resample",
    "linrad_tpu_torch.ops.sellim",
    "linrad_tpu_torch.ops.squelch",
    "linrad_tpu_torch.ops.timf2",
    "linrad_tpu_torch.ops.windows",
    "linrad_tpu_torch.parallel",
    "linrad_tpu_torch.parallel.fleet",
    "linrad_tpu_torch.pipeline.batch",
    "linrad_tpu_torch.pipeline.chain",
    "linrad_tpu_torch.pipeline.checkpoint",
    "linrad_tpu_torch.pipeline.control",
    "linrad_tpu_torch.pipeline.latency",
    "linrad_tpu_torch.pipeline.receiver",
    "linrad_tpu_torch.runtime",
    "linrad_tpu_torch.runtime.watchdog",
    "linrad_tpu_torch.utils.llsq",
    "linrad_tpu_torch.utils.scanops",
    "linrad_tpu_torch.utils.segments",
    "linrad_tpu_torch.utils.timing",
    "linrad_tpu_torch.weak.afc",
    "linrad_tpu_torch.weak.pol",
    "linrad_tpu_torch.weak.radar",
    "linrad_tpu_torch.weak.spur",
]

# printed by the child: the loaded modules named jax, jax.*, linrad_tpu or
# linrad_tpu.* (linrad_tpu_torch is another package and does not count)
FOREIGN = ("print(sorted(m for m in sys.modules if m.split('.')[0] in "
           "('jax', 'jaxlib', 'linrad_tpu')))\n")


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("module", MODULES)
def test_module_does_not_import_jax(module):
    proc = _run(f"import sys, importlib\n"
                f"importlib.import_module({module!r})\n" + FOREIGN)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_modules_list_is_complete():
    """Every module of the package is in MODULES."""
    pkg = ROOT / "linrad_tpu_torch"
    found = set()
    for path in pkg.rglob("*.py"):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        found.add(".".join(parts))
    # runtime is a subpackage with code of its own (the ctypes bindings)
    subpackages = {"linrad_tpu_torch.io", "linrad_tpu_torch.ops",
                   "linrad_tpu_torch.pipeline", "linrad_tpu_torch.utils",
                   "linrad_tpu_torch.weak"}
    assert found - subpackages == set(MODULES)
    for sub in ("io.", "runtime", "weak.radar", "pipeline.batch",
                "calibration", "parallel.fleet"):
        assert any(m.startswith("linrad_tpu_torch." + sub) for m in MODULES)


def _imported_names(path: Path) -> list[tuple[int, str]]:
    """(line, module) of every absolute import in a source file."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append((node.lineno, node.module or ""))
    return names


def test_sources_import_neither_jax_nor_the_jax_package():
    """Static: no import statement anywhere in the port or in
    chip_smoke.py (inside functions included) names jax or linrad_tpu."""
    files = sorted((ROOT / "linrad_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 25
    bad = [f"{path.relative_to(ROOT)}:{line}: {name}"
           for path in files for line, name in _imported_names(path)
           if name.split(".")[0] in ("jax", "jaxlib", "linrad_tpu")]
    assert not bad, bad


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
        + FOREIGN)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_cpu_eme_receiver_does_not_import_jax():
    """The tiny EME Receiver (two channels, adaptive polarization,
    coherent detection, AFC) runs 5 steps, so the AFC acquires, jax-free."""
    proc = _run(
        "import sys, numpy as np\n"
        "from linrad_tpu_torch import RxMode, preset\n"
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
        "assert outs[-1].audio.shape == "
        "(rx.geo.baseband_samples_per_step, 1)\n"
        + FOREIGN)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_cpu_multi_receiver_does_not_import_jax():
    """A tiny MultiReceiver with K = 3 sub-receivers, spur cancellation,
    squelch and expander runs 4 steps with the spur manager scanning every
    second one, then a real-input Receiver on mixer mode 2 with the audio
    resampler runs 2, all jax-free."""
    proc = _run(
        "import sys, dataclasses, numpy as np\n"
        "from linrad_tpu_torch import InputMode, flagship_params\n"
        "from linrad_tpu_torch.pipeline.control import WeakSignalControl\n"
        "from linrad_tpu_torch.pipeline.receiver import MultiReceiver, "
        "Receiver\n"
        "p = dataclasses.replace(flagship_params(tiny=True), "
        "spur_enable=True, squelch_enable=True, expander_exponent=2.0)\n"
        "rx = MultiReceiver(p, 3, device='cpu')\n"
        "for k in range(3):\n"
        "    rx.tune_subch(k, 1000.0 + 4000.0 * k)\n"
        "ctl = WeakSignalControl(rx.geo, p, 'cpu')\n"
        "ctl.spur_scan_interval = 2\n"
        "rng = np.random.default_rng(0)\n"
        "n = 4 * rx.geo.samples_per_step\n"
        "t = np.arange(n) / rx.geo.timf1_sampling_speed\n"
        "iq = (rng.normal(size=n) + 1j * rng.normal(size=n)"
        " + 100.0 * np.exp(2j * np.pi * -20000.0 * t)).astype(np.complex64)\n"
        "for out in rx.run(iq):\n"
        "    _bins, rx.state = ctl.update(out, rx._tune_bins, rx.state)\n"
        "assert out.audio.shape == "
        "(3, rx.geo.baseband_samples_per_step, 1)\n"
        "assert int((rx.state.spur.bins >= 0).sum()) >= 1\n"
        "assert ctl.host_reads == 12\n"
        "p = dataclasses.replace(flagship_params(tiny=True), "
        "input_mode=InputMode.REAL, mixer_mode=2)\n"
        "rx = Receiver(p, device='cpu', audio_out_rate=2 * 3000.0)\n"
        "x = rng.normal(size=4 * rx.geo.samples_per_step)"
        ".astype(np.float32)\n"
        "outs = list(rx.run(x))\n"
        "assert len(outs) == 2 and outs[-1].audio.shape == "
        "(2 * rx.geo.baseband_samples_per_step, 1)\n"
        + FOREIGN)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_cpu_host_layer_does_not_import_jax():
    """The host layer on a tiny receiver, jax-free: a WAV written and
    replayed through the prefetcher, a checkpoint saved and resumed, two
    calls of the batch runner, the latency report and a radar tracker's
    feed."""
    proc = _run(
        "import sys, os, tempfile, numpy as np\n"
        "from linrad_tpu_torch import flagship_params\n"
        "from linrad_tpu_torch.io.siggen import Tone, tones_iq\n"
        "from linrad_tpu_torch.io.wav import RcvrChunk, write_wav\n"
        "from linrad_tpu_torch.pipeline.batch import BatchRunner\n"
        "from linrad_tpu_torch.pipeline.checkpoint import load_receiver, "
        "save_receiver\n"
        "from linrad_tpu_torch.pipeline.latency import latency_params, "
        "measure_latency\n"
        "from linrad_tpu_torch.pipeline.receiver import Receiver\n"
        "from linrad_tpu_torch.weak.radar import RadarTracker\n"
        "p = flagship_params(tiny=True)\n"
        "rx = Receiver(p, device='cpu')\n"
        "rx.tune(1000.0)\n"
        "s = rx.geo.samples_per_step\n"
        "iq = tones_iq(96000, 4 * s, [Tone(1300.0, amplitude=900.0)])\n"
        "d = tempfile.mkdtemp()\n"
        "wav = os.path.join(d, 'a.wav')\n"
        "write_wav(wav, iq[:, None], 96000, rcvr=RcvrChunk("
        "center_frequency_hz=7000000))\n"
        "assert len(list(rx.run_file(wav))) == 4\n"
        "assert rx.center_frequency_hz == 7000000.0\n"
        "save_receiver(os.path.join(d, 'c.npz'), rx)\n"
        "rx2 = load_receiver(os.path.join(d, 'c.npz'), device='cpu')\n"
        "assert rx2._steps_done == 4\n"
        "br = BatchRunner(p, k_steps=2, device='cpu')\n"
        "assert br.process(iq)['audio'].shape == "
        "(4 * rx.geo.baseband_samples_per_step, 1)\n"
        "rep = measure_latency(latency_params(), steps=2, warmup=1, "
        "device='cpu')\n"
        "assert rep['budget_ms'] == 150.0\n"
        "trk = RadarTracker(n_bins=256, frame_time_s=0.01, device='cpu')\n"
        "trk.feed(np.random.default_rng(0).random((8, 256)))\n"
        "assert not trk.locked\n"
        + FOREIGN)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_cpu_fleet_and_variants_do_not_import_jax():
    """A tiny FleetRunner of 2 streams (one call of 2 steps), a Receiver
    with the round-parallel blanker, the mxu fft1 variant and a filtercorr
    from the calibration copy, jax-free."""
    proc = _run(
        "import sys, dataclasses, numpy as np\n"
        "from linrad_tpu_torch import calibration, flagship_params\n"
        "from linrad_tpu_torch.parallel import FleetRunner\n"
        "from linrad_tpu_torch.pipeline.receiver import Receiver\n"
        "p = flagship_params(tiny=True)\n"
        "fl = FleetRunner(p, 2, k_steps=2, device='cpu')\n"
        "fl.tune([1000.0, -2000.0])\n"
        "rng = np.random.default_rng(0)\n"
        "n = 2 * fl.geo.samples_per_step\n"
        "iq = (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n)))"
        ".astype(np.complex64)\n"
        "assert fl.process(iq)['audio'].shape == "
        "(2, 2 * fl.geo.baseband_samples_per_step, 1)\n"
        "fc = calibration.make_filtercorr("
        "np.linspace(1.0, 2.0, fl.geo.fft1_size))\n"
        "q = dataclasses.replace(p, blanker_rounds=8, fft1_variant='mxu')\n"
        "rx = Receiver(q, {'filtercorr': fc}, device='cpu')\n"
        "rx.tune(1000.0)\n"
        "outs = list(rx.run(iq[0]))\n"
        "assert len(outs) == 2\n"
        + FOREIGN)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout
