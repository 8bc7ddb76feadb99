"""utils/fporder.py: float32 sums and prefix sums in XLA's CPU order,
bit for bit against jnp.cumsum and jnp.sum (jitted), and mix1's
fractional-bin ramp built on them against the JAX package's frac_ramp:
the carried phase bit for bit, the ramp within the rounding of cos and
sin (2e-7), with and without the per-frame slope, at every preset's
shape.  The ramp's rounding is what reached the 3 kHz presets' baseband
amplified (tests/test_torch_presets_variants.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linrad_tpu import RxMode, derive_geometry, preset
from linrad_tpu.ops import mix1 as jmix1
from linrad_tpu_torch import convert
from linrad_tpu_torch import derive_geometry as t_derive_geometry
from linrad_tpu_torch.ops import mix1 as tmix1
from linrad_tpu_torch.utils.fporder import ordered_cumsum, ordered_sum

LENGTHS = [1, 2, 15, 16, 17, 32, 33, 100, 512, 1000, 2048, 4096, 16384,
           65536]


def _data(shape, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.random(shape) * 0.01 + 0.001).astype(np.float32)


@pytest.mark.parametrize("n", LENGTHS)
def test_ordered_cumsum_is_xla_cumsum(n):
    x = _data(n, n)
    got = ordered_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jnp.cumsum)(x)))


@pytest.mark.parametrize("n", LENGTHS)
def test_ordered_sum_is_xla_sum(n):
    x = _data(n, n + 1)
    got = ordered_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jnp.sum)(x)))


def test_last_axis_of_a_stack():
    """K stacked rows (the multi-receiver's frac_ramp) along the last
    axis, as jnp along axis -1."""
    x = _data((3, 2048), 5)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(
        ordered_cumsum(t).numpy(),
        np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(x)))
    np.testing.assert_array_equal(
        ordered_sum(t).numpy(),
        np.asarray(jax.jit(lambda a: jnp.sum(a, axis=-1))(x)))


def test_torch_orders_differ():
    """The reason for the module: torch's own sums round otherwise."""
    x = _data(2048, 3)
    ref = np.asarray(jax.jit(jnp.cumsum)(x))
    assert not np.array_equal(torch.cumsum(torch.from_numpy(x), 0).numpy(),
                              ref)


@pytest.mark.parametrize("mode", ["SSB", "NCW", "HSMS", "FM", "WCW", "QRSS"])
@pytest.mark.parametrize("slope", [False, True])
def test_frac_ramp_against_jax(mode, slope):
    p = preset(RxMode[mode])
    geo = derive_geometry(p)
    tgeo = t_derive_geometry(convert.params_from_jax(p))
    n = geo.fftx_frames_per_step
    rng = np.random.default_rng(11)
    phase = np.float32(rng.random())
    frac = (rng.random(n) - 0.5).astype(np.float32)
    sl = (rng.random(n) * 0.1 - 0.05).astype(np.float32) if slope else None
    jr, jp = jax.jit(lambda a, b, c: jmix1.frac_ramp(geo, a, b, c, n))(
        phase, frac, sl)
    tr, tp = tmix1.frac_ramp(tgeo, torch.tensor(phase), torch.from_numpy(frac),
                             None if sl is None else torch.from_numpy(sl), n)
    assert float(tp) == float(jp)
    assert np.abs(tr.numpy() - np.asarray(jr)).max() <= 2e-7
