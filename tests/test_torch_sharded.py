"""The port's time-sharded receiver (linrad_tpu_torch/parallel/sharded.py)
against the JAX package's ShardedReceiver on four virtual CPU devices
(tests/conftest.py forces eight; the JAX side takes
``jax.devices()[:4]``), the port's on ``LocalGroup(["cpu"] * 4)``, at
tests/test_sharded.py's ``_base()`` parameters with shards=4 (96 kHz IQ,
fft1 2048, 65,536 samples per step), from the same tables and state
carried across by linrad_tpu_torch.convert, over 4 or more steps.

The configurations are split over this file and
tests/test_torch_sharded_options.py, so that ``--dist loadfile`` runs
them side by side; each JAX run is made once, in a module fixture.  The
multi-receiver and batch runners, and the collectives on their own, are
in tests/test_torch_sharded_runners.py.

Bars, per RxOutputs field (max_rel over every step, as
tests/test_torch_chain.py): blanker counts exact, liminfo sign pattern
exact, audio <= 2.3e-4, fft2_power <= 1e-6, every other float <= 1e-4;
the final state: integers exact, floats <= 1e-4.  The comparison is
against JAX's sharded step, not against a single-device step: the means
over shards sum in another order than one device's mean.
"""


import numpy as np
import jax
import pytest

from linrad_tpu import InputMode, RxParams, derive_geometry
from linrad_tpu.io.siggen import Tone, impulse_noise, tones_iq
from linrad_tpu.params import Demod
from linrad_tpu.parallel import ShardedReceiver as JaxShardedReceiver
from linrad_tpu_torch import convert
from linrad_tpu_torch.parallel import ShardedReceiver

D = 4
FIELDS = ["audio", "baseb", "fft1_power", "fft1_avg_power", "agc_gain",
          "fft2_power", "liminfo", "blanker_fitted", "blanker_cleared",
          "noise_floor"]
WIDE_ONLY = ("fft2_power", "liminfo", "blanker_fitted", "blanker_cleared",
             "noise_floor")
BARS = {"audio": 2.3e-4, "fft2_power": 1e-6}
OTHER_BAR = 1e-4


def base(**kw) -> dict:
    """tests/test_sharded.py's _base()."""
    d = dict(first_fft_bandwidth=100.0, mix1_bandwidth_reduction_n=4,
             agc_enable=False)
    d.update(kw)
    return d


WIDE = dict(second_fft_enable=True, blanker_enable=True,
            clever_bln_limit=6.0, stupid_bln_limit=4.0,
            max_pulses_per_block=64)


def noise(rng, n, sigma=0.02, shape=None) -> np.ndarray:
    shape = shape or (n,)
    return ((rng.normal(size=shape) + 1j * rng.normal(size=shape)) * sigma
            ).astype(np.complex64)


def edge_pulses(geo, steps: int, seed: int) -> np.ndarray:
    """A tone, noise, impulse noise, and in every step strong pulses on
    the shard boundaries (tests/test_sharded.py:104-136)."""
    rng = np.random.default_rng(seed)
    fs = geo.rx_ad_speed
    n = geo.samples_per_step * steps
    iq = (tones_iq(fs, n, [Tone(12_400.0)]) + noise(rng, n)
          + impulse_noise(rng, n, 50.0, fs, 30.0))
    shard = geo.samples_per_step // D
    for s in range(steps):
        for b in range(1, D):
            iq[s * geo.samples_per_step + b * shard + (s % 3) - 1] += 40.0
    return iq


def tone(geo, steps: int, seed: int = 0, hz: float = 12_400.0):
    rng = np.random.default_rng(seed)
    n = geo.samples_per_step * steps
    return tones_iq(geo.rx_ad_speed, n, [Tone(hz)]) + noise(rng, n, 0.01)


def drifting(geo, steps: int, seed: int = 0) -> np.ndarray:
    """tests/test_sharded.py's AFC input: a carrier drifting 2 Hz/s."""
    fs = geo.rx_ad_speed
    n = geo.samples_per_step * steps
    t = np.arange(n) / fs
    rng = np.random.default_rng(seed)
    return (0.3 * np.exp(2j * np.pi * (10_000.0 * t + t * t))
            + noise(rng, n, 0.05)).astype(np.complex64)


def two_channel(geo, steps: int, seed: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = geo.samples_per_step * steps
    t1 = tones_iq(geo.rx_ad_speed, n, [Tone(12_400.0)])
    return (np.stack([t1, 0.5 * t1], 1)
            + noise(rng, n, 0.05, (n, 2))).astype(np.complex64)


def real_tone(geo, steps: int) -> np.ndarray:
    n = 2 * geo.samples_per_step * steps
    t = np.arange(n) / geo.rx_ad_speed
    return np.cos(2 * np.pi * 12_400.0 * t).astype(np.float32)


def spur_input(geo, steps: int) -> np.ndarray:
    """tests/test_sharded.py's spur input (a weak tone at the dial, a
    carrier 500 Hz over it), with the noise 47 dB under the carrier, as
    tests/test_torch_spur.py puts it: the cleaned spectra are what is left
    of a subtraction, and at 66 dB under (the JAX test's) fp32 roundoff
    of the carrier is 4e-4 of what is left (ROADMAP.md queue 3)."""
    rng = np.random.default_rng(0)
    n = geo.samples_per_step * steps
    return (tones_iq(geo.rx_ad_speed, n, [Tone(12_400.0, amplitude=0.5)])
            + tones_iq(geo.rx_ad_speed, n, [Tone(12_900.0, amplitude=20.0)])
            + noise(rng, n, 0.09))


def iq_corr(geo) -> dict:
    """tests/test_sharded.py's synthetic image-correction table."""
    k = np.arange(geo.fft1_size)
    return {"iq_corr": (0.04 * np.exp(2j * np.pi * k / geo.fft1_size)
                        ).astype(np.complex64)[:, None]}


# name: (params, input(geo, steps), steps, tune Hz, calibration(geo))
CONFIGS = {
    "narrowband": (base(), tone, 4, 12_000.0, None),
    "wideband-blanker": (base(**WIDE), lambda g, s: edge_pulses(g, s, 0), 4,
                         12_000.0, None),
    "pol-adapt": (base(rx_rf_channels=2, pol_adapt_enable=True),
                  two_channel, 4, 12_000.0, None),
    "spur": (base(filter_low_hz=-1500.0, filter_high_hz=1500.0,
                  spur_enable=True), spur_input, 5, 12_400.0, None),
    "afc-frames": (base(afc_enable=True, afc_coherent=False,
                        first_fft_bandwidth=30.0, filter_low_hz=-150.0,
                        filter_high_hz=150.0), drifting, 7, 10_000.0, None),
    "afc-coherent": (base(afc_enable=True, first_fft_bandwidth=30.0,
                          filter_low_hz=-150.0, filter_high_hz=150.0),
                     drifting, 7, 10_000.0, None),
    "iq-corr": (base(), tone, 4, 12_000.0, iq_corr),
    "real-input": (base(input_mode=InputMode.REAL, filter_low_hz=-1000.0,
                        filter_high_hz=1000.0), lambda g, s: real_tone(g, s),
                   4, 12_000.0, None),
    "mixer-mode-2": (base(mixer_mode=2, mix2_reduction_n=2,
                          demod=Demod.NONE),
                     lambda g, s: tone(g, s, hz=12_150.0), 4, 12_000.0, None),
}


def max_rel(a, b) -> float:
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return float(np.max(np.abs(a - b))
                 / max(np.max(np.abs(a)), np.max(np.abs(b)), 1e-30))


def run_both(name: str) -> dict:
    """JAX's ShardedReceiver and the port's over the same input, the
    port's started from the JAX one's tables and state."""
    kw, make_input, steps, tune_hz, cal = CONFIGS[name]
    jp = RxParams(**kw, shards=D)
    cal = cal(derive_geometry(jp)) if cal else None
    jrx = JaxShardedReceiver(jp, devices=jax.devices()[:D], calibration=cal)
    trx = ShardedReceiver(convert.params_from_jax(jp), ["cpu"] * D,
                          calibration=cal)
    trx.tables = convert.tables_from_numpy(convert.flatten(jrx.tables),
                                           "cpu")
    trx.state = convert.state_from_numpy(convert.flatten(jrx.state), "cpu")
    jrx.tune(tune_hz)
    trx.tune(tune_hz)
    iq = make_input(jrx.geo, steps)
    j_out, t_out, status = [], [], []
    for jo, to in zip(jrx.run(iq), trx.run(iq)):
        j_out.append(jo)
        t_out.append(to)
        if jrx.control.afc is not None:
            status.append((jrx.control.afc.status, trx.control.afc.status,
                           np.asarray(jrx._tune_bin).tolist(),
                           trx._tune_bin.tolist()))
    assert len(j_out) == len(t_out) == steps
    return dict(name=name, params=jp, jrx=jrx, trx=trx, j_out=j_out,
                t_out=t_out, afc=status)


def check_field(run: dict, field: str) -> None:
    jv = [getattr(o, field) for o in run["j_out"]]
    tv = [getattr(o, field) for o in run["t_out"]]
    if not run["params"].second_fft_enable and field in WIDE_ONLY:
        assert all(v is None for v in jv + tv)
        return
    for a, b in zip(tv, jv):
        assert tuple(a.shape) == tuple(np.shape(b)), field
    if field in ("blanker_fitted", "blanker_cleared"):
        assert [int(v) for v in tv] == [int(v) for v in jv]
        return
    t_arr = np.stack([v.numpy() for v in tv])
    j_arr = np.stack([np.asarray(v) for v in jv])
    if field == "liminfo":
        np.testing.assert_array_equal(np.sign(t_arr), np.sign(j_arr))
    assert max_rel(t_arr, j_arr) <= BARS.get(field, OTHER_BAR), \
        (run["name"], field, max_rel(t_arr, j_arr))


def check_state(run: dict) -> None:
    ref = convert.flatten(run["jrx"].state)
    port = convert.state_to_numpy(run["trx"].state)
    assert sorted(port) == sorted(ref)
    for k, v in port.items():
        assert v.dtype == ref[k].dtype, k
        if v.dtype.kind in "iub":
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
        else:
            assert max_rel(v, ref[k]) <= OTHER_BAR, k


def check_not_vacuous(run: dict) -> None:
    j_out = run["j_out"]
    assert max(float(np.abs(np.asarray(o.audio)).max()) for o in j_out) > 0
    if run["params"].blanker_enable:
        assert sum(int(o.blanker_fitted) for o in j_out) > 0
        assert sum(int(o.blanker_cleared) for o in j_out) > 0
    for jstat, tstat, jbins, tbins in run["afc"]:
        assert jstat == tstat and jbins == tbins


HERE = ["narrowband", "wideband-blanker", "pol-adapt", "spur"]


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


def test_shards_and_work(runs):
    """Each run has as many shards as devices; the wideband configuration
    fits pulses once the noise floor has settled (the floor starts 23 dB
    up, so the first steps fit none), the spur manager holds a slot."""
    trx = runs["trx"]
    assert trx.group.axis_size == D and trx.params.shards == D
    if runs["name"] == "wideband-blanker":
        assert int(runs["t_out"][-1].blanker_fitted) > 0
    if runs["name"] == "spur":
        assert int((trx.state.spur.bins >= 0).sum()) >= 1
