"""The port's FleetRunner (linrad_tpu_torch/parallel/fleet.py): R receivers
as one torch.func.vmap'd step, K steps per call.

Held to the JAX package's FleetRunner (built on one device: conftest
forces eight virtual CPU devices) and to R separate port Receivers on
the same dials (mirroring tests/test_sharded.py's TestFleet), at
_flagship_params(tiny=True) with the fused fft1 ("pallas": the JAX
kernel in interpret mode under its vmap, the port's custom operator
folding the streams into the channel axis onto its plain version), R =
3 streams with their own dials, two calls of K = 2 steps.

Bars: audio within 2.3e-4 and baseb within 1e-4 (max_rel per stream,
ROADMAP "Rules of the port"); the carried state within 1e-4, integers
exact.  The vmapped step must take no operation down vmap's slow path:
its warning is an error in every test here.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from __graft_entry__ import _flagship_params
from linrad_tpu.parallel import FleetRunner as JaxFleetRunner
from linrad_tpu_torch import InputMode, convert
from linrad_tpu_torch.ops.fused_fft1 import fused_fft1
from linrad_tpu_torch.parallel import FleetRunner
from linrad_tpu_torch.pipeline.receiver import Receiver

pytestmark = pytest.mark.filterwarnings(
    "error:There is a performance drop:UserWarning")

R = 3
K = 2
CALLS = 2
FIELDS = ("audio", "baseb")
BARS = {"audio": 2.3e-4, "baseb": 1e-4}
DIALS = 12_000.0 + np.array([0.0, 3_330.7, -7_777.3])
JP = dataclasses.replace(_flagship_params(tiny=True), fft1_variant="pallas")
TP = convert.params_from_jax(JP)


def _max_rel(a, b) -> float:
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return float(np.max(np.abs(a - b))
                 / max(np.max(np.abs(a)), np.max(np.abs(b)), 1e-30))


def _streams(geo, extra: int = 0) -> np.ndarray:
    """(R, T) IQ: per stream a tone 400 Hz over its dial, noise, a strong
    carrier (liminfo strong bins) and 12 impulses a step (blanker work);
    ``extra`` samples more than the calls take."""
    n = CALLS * K * geo.samples_per_step + extra
    t = np.arange(n) / geo.timf1_sampling_speed
    out = []
    for r, dial in enumerate(DIALS):
        rng = np.random.default_rng(20 + r)
        x = (3.0 * (rng.normal(size=n) + 1j * rng.normal(size=n))
             + 100.0 * np.exp(2j * np.pi * -20_000.0 * t + 0.7j * r)
             + 2.0 * np.exp(2j * np.pi * (dial + 400.0) * t))
        pos = rng.integers(0, n, 12 * CALLS * K)
        x[pos] += 300.0 * np.exp(2j * np.pi * rng.uniform(size=pos.size))
        out.append(x)
    return np.stack(out).astype(np.complex64)


@pytest.fixture(scope="module")
def fleets():
    """Both fleets over the same streams, the port's started from the JAX
    fleet's state carried across (leading stream axis) and its tables."""
    jfl = JaxFleetRunner(JP, n_streams=R, k_steps=K, outputs=FIELDS,
                         devices=jax.devices()[:1])
    tfl = FleetRunner(TP, R, k_steps=K, outputs=FIELDS, device="cpu")
    state = convert.state_from_numpy(convert.flatten(jfl.state), "cpu")
    tfl.graphed.state = state
    jfl.tune(DIALS)
    tfl.tune(DIALS)
    iq = _streams(jfl.geo, extra=100)
    fused_fft1.launches = 0
    return jfl, tfl, iq, jfl.process(iq), tfl.process(iq)


@pytest.mark.parametrize("field", FIELDS)
def test_fleet_against_jax(fleets, field):
    jfl, _tfl, _iq, j_out, t_out = fleets
    bb = jfl.geo.baseband_samples_per_step
    assert t_out[field].shape == j_out[field].shape == \
        (R, CALLS * K * bb, 1)
    for r in range(R):
        assert _max_rel(t_out[field][r], j_out[field][r]) <= BARS[field]
    assert np.abs(j_out[field]).max() > 0


def test_fleet_state_against_jax(fleets):
    """The carried state after the calls, stream axis in front."""
    jfl, tfl, _iq, _j, _t = fleets
    ref = convert.flatten(jfl.state)
    port = convert.state_to_numpy(tfl.state)
    assert sorted(port) == sorted(ref)
    for k, v in port.items():
        assert v.shape[0] == R and v.shape == ref[k].shape, k
        assert v.dtype == ref[k].dtype, k
        if v.dtype.kind in "iub":
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
        else:
            assert _max_rel(v, ref[k]) <= 1e-4, k


def test_fleet_against_receivers(fleets):
    """Each stream equals a port Receiver on its own dial (fractional
    tuning on both), and the streams differ from one another."""
    jfl, _tfl, iq, _j, t_out = fleets
    per = CALLS * K * jfl.geo.samples_per_step
    for r in range(R):
        rx = Receiver(TP, device="cpu")
        rx.tune(DIALS[r])
        outs = list(rx.run(iq[r, :per]))
        for f in FIELDS:
            ref = torch.cat([getattr(o, f) for o in outs]).numpy()
            assert _max_rel(t_out[f][r], ref) <= BARS[f], (r, f)
    assert _max_rel(t_out["audio"][0], t_out["audio"][1]) > 0.1


def test_one_kernel_call_per_step(fleets, monkeypatch):
    """The fused fft1's vmap rule serves the R streams with one call per
    step, at (B, N, R C); on the CPU that call runs the plain version
    and counts no launch."""
    import linrad_tpu_torch.ops.fused_fft1 as ff
    _jfl, tfl, _iq, _j, _t = fleets
    assert fused_fft1.launches == 0
    seen = []
    plain = ff.fused_fft1_reference

    def spy(frames, window, filtercorr):
        seen.append(tuple(frames.shape))
        return plain(frames, window, filtercorr)

    monkeypatch.setattr(ff, "fused_fft1_reference", spy)
    tfl.process(_streams(tfl.geo)[:, : K * tfl.geo.samples_per_step])
    g = tfl.geo
    assert seen == [(g.fft1_frames_per_step, g.fft1_size, R)] * K
    assert fused_fft1.launches == 0


def test_fleet_process_shapes(fleets):
    """Trailing samples short of a call are dropped; (R, T, C) input goes
    as (R, T); too few samples give empty outputs; the stream count must
    match."""
    jfl, tfl, iq, _j, t_out = fleets
    s = jfl.geo.samples_per_step
    got = tfl.process(iq[:, : K * s + 5, None])
    assert got["audio"].shape == (R, K * jfl.geo.baseband_samples_per_step,
                                  1)
    assert tfl.process(iq[:, : s])["audio"].shape == (R, 0, 1)
    assert tfl.samples_per_call == K * s
    with pytest.raises(ValueError, match="streams"):
        tfl.process(iq[:2])


def test_fleet_tune_broadcast():
    tfl = FleetRunner(TP, 2, k_steps=1, device="cpu")
    tfl.tune(1_000.0)
    n, fs = tfl.geo.fftx_size, tfl.geo.timf1_sampling_speed
    t1 = 1_000.0 / fs * n
    assert tfl._tune_bins.tolist() == [round(t1) % n] * 2
    assert torch.equal(tfl._tune_fracs,
                       torch.full((2,), t1 - round(t1), dtype=torch.float32))


def test_fleet_refusals():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FleetRunner(TP, 2, device=["cpu", "cpu"])
    with pytest.raises(ValueError, match="IQ"):
        FleetRunner(dataclasses.replace(TP, input_mode=InputMode.REAL), 2,
                    device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            FleetRunner(TP, 2)


@pytest.mark.parametrize("batched", ["frames", "frames+filtercorr",
                                     "filtercorr"])
def test_fused_fft1_vmap_rule(batched):
    """The rule's fold (streams into channels) gives each stream what a
    call on it alone gives: spectra bit for bit, power sums within fp32
    (another summation order on the CPU).  An unbatched operand is
    shared by every stream; a batched window is refused."""
    rng = np.random.default_rng(3)
    b, n, c = 5, 256, 2

    def cn(*shape):
        return torch.from_numpy((rng.normal(size=shape)
                                 + 1j * rng.normal(size=shape)
                                 ).astype(np.complex64))

    bf, bc = "frames" in batched, "filtercorr" in batched
    frames = cn(R, b, n, c) if bf else cn(b, n, c)
    window = torch.from_numpy(rng.random(n).astype(np.float32))
    fc = cn(R, n, c) if bc else cn(n, c)
    dims = (0 if bf else None, None, 0 if bc else None)
    spec, psum = torch.func.vmap(fused_fft1, in_dims=dims)(frames, window,
                                                           fc)
    assert spec.shape == (R, b, n, c) and psum.shape == (R, n, c)
    for r in range(R):
        s1, p1 = fused_fft1((frames[r] if bf else frames).contiguous(),
                            window, (fc[r] if bc else fc).contiguous())
        assert torch.equal(spec[r], s1)
        assert _max_rel(psum[r].numpy(), p1.numpy()) <= 1e-6
    with pytest.raises(NotImplementedError, match="window"):
        torch.func.vmap(fused_fft1, in_dims=(None, 0, None))(
            frames[0] if bf else frames, window[None].expand(R, n),
            fc[0] if bc else fc)
