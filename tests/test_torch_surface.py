"""The last pieces of the JAX package's public surface in the port, each
against its JAX twin on the CPU at the tiny flagship cut (fft1 256, fft2
512, fft3 64): ``framing.make_tail`` and ``fft2.fft2_step``.

Inputs come from numpy with fixed seeds and go to both packages.  Max
relative error is max|a-b| / max(max|a|, max|b|) per array.  Bars, with
their reasons:

- EXACT: ``make_tail`` (zeros of a shape and dtype), ``fft2_step``
  against its two parts in the port.
- FFT2_POWER: 1e-6, the parity rule's fft2_power bar, for ``fft2_step``'s
  spectra and step power; its slow average 1e-4, the rule's bar for the
  other float fields.
- FFT: 1e-5 for the port's fft1 spectra against numpy's FFT of the same
  frames: float32 transforms, summed in another order.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _flagship_params
from linrad_tpu import derive_geometry
from linrad_tpu.ops import fft2 as jfft2
from linrad_tpu.ops import framing as jframing
from linrad_tpu_torch import convert
from linrad_tpu_torch import derive_geometry as t_derive_geometry
from linrad_tpu_torch.ops import fft1 as tfft1
from linrad_tpu_torch.ops import fft2 as tfft2
from linrad_tpu_torch.ops import framing as tframing

FFT2_POWER = 1e-6
FIELD = 1e-4
FFT = 1e-5
CPU = "cpu"

P = _flagship_params(tiny=True)
GEO = derive_geometry(P)
T_P = convert.params_from_jax(P)
T_GEO = t_derive_geometry(T_P)


def _rel(a, b) -> float:
    a = np.asarray(a).astype(np.complex128)
    b = np.asarray(b).astype(np.complex128)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b))
                 / max(np.max(np.abs(a)), np.max(np.abs(b)), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x))


def _cnoise(rng, shape, scale=1.0):
    return (scale * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
            ).astype(np.complex64)


def _equal(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(a, b)


# ---- make_tail --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["complex64", "float32"])
@pytest.mark.parametrize("trailing", [(), (1,), (3, 2)])
def test_make_tail(dtype, trailing):
    """Zeros of JAX's shape and dtype, on the device named."""
    j = jframing.make_tail(256, 96, trailing, dtype=getattr(jnp, dtype))
    t = tframing.make_tail(256, 96, trailing, dtype=getattr(torch, dtype),
                           device=CPU)
    assert tuple(t.shape) == j.shape == (160,) + trailing
    assert str(t.dtype) == f"torch.{j.dtype}"
    assert t.device == torch.device(CPU)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    d = tframing.make_tail(16, 10, trailing, device=CPU)
    assert d.dtype == torch.complex64 and tuple(d.shape) == (6,) + trailing


def test_make_tail_frames_cover_stream():
    """tests/test_windows_framing.py's framing checks on the port's
    frame_stream (sample axis, then a channel axis) with its make_tail."""
    size, hop = 16, 10
    tail = tframing.make_tail(size, hop, (1,), torch.float32, device=CPU)
    block = torch.arange(40, dtype=torch.float32)[:, None]
    frames, new_tail = tframing.frame_stream(tail, block, size, hop)
    assert tuple(frames.shape) == (4, 16, 1)
    np.testing.assert_array_equal(frames[0, 6:, 0].numpy(), np.arange(10))
    assert torch.equal(frames[1, : size - hop], frames[0, hop:])
    np.testing.assert_array_equal(new_tail[:, 0].numpy(), np.arange(34, 40))
    # two small steps == one big step
    size, hop = 32, 24
    x = _t(np.random.default_rng(0).normal(size=(96, 1)).astype(np.float32))
    t0 = tframing.make_tail(size, hop, (1,), torch.float32, device=CPU)
    f1, t1 = tframing.frame_stream(t0, x[:48], size, hop)
    f2, _ = tframing.frame_stream(t1, x[48:], size, hop)
    fall, _ = tframing.frame_stream(t0, x, size, hop)
    assert torch.equal(torch.cat([f1, f2]), fall)
    # rectangular frames at full hop, overlap-added: the identity
    f, _ = tframing.frame_stream(
        tframing.make_tail(16, 16, (1,), torch.float32, device=CPU),
        x[:64], 16, 16)
    out, _ = tframing.overlap_add(f, 16, torch.zeros((0, 1)))
    assert torch.equal(out, x[:64])


def test_make_tail_fft1_streaming():
    """tests/test_fft1.py:123 on the port: two fft1 steps equal the window
    and transform of the whole stream framed from a make_tail tail."""
    tables = tfft1.FFT1Tables.create(T_GEO, CPU, edge_taper=False)
    rng = np.random.default_rng(3)
    n = T_GEO.samples_per_step
    x = _cnoise(rng, (2 * n, 1))
    s = tfft1.FFT1State.create(T_GEO, CPU)
    s1, spec1, _ = tfft1.fft1_step(T_GEO, tables, s, _t(x[:n]), 8)
    _, spec2, _ = tfft1.fft1_step(T_GEO, tables, s1, _t(x[n:]), 8)
    tail = tframing.make_tail(T_GEO.fft1_size, T_GEO.fft1_new_points, (1,),
                              device=CPU)
    frames, _ = tframing.frame_stream(tail, _t(x), T_GEO.fft1_size,
                                      T_GEO.fft1_new_points)
    ref = np.fft.fft(frames.numpy() * tables.window.numpy()[None, :, None],
                     axis=1)
    assert _rel(torch.cat([spec1, spec2]).numpy(), ref) <= FFT


# ---- fft2_step --------------------------------------------------------

def _fft2_inputs(steps=3):
    rng = np.random.default_rng(9)
    return [(_cnoise(rng, (GEO.samples_per_step, 1)),
             _cnoise(rng, (GEO.samples_per_step, 1), 5.0))
            for _ in range(steps)]


@pytest.mark.parametrize("avg2num", [1, 8])
def test_fft2_step(avg2num):
    """Three steps against JAX's fft2_step, and bit for bit against
    fft2_transform then fft2_power_update in the port."""
    j_tab = jfft2.FFT2Tables.create(GEO)
    t_tab = tfft2.FFT2Tables.create(T_GEO, CPU)
    j_st = jfft2.FFT2State.create(GEO)
    t_st = parts = tfft2.FFT2State.create(T_GEO, CPU)
    for weak, strong in _fft2_inputs():
        j_st, js, jp = jfft2.fft2_step(GEO, j_tab, j_st, jnp.asarray(weak),
                                       jnp.asarray(strong), avg2num)
        t_st, ts, tp = tfft2.fft2_step(T_GEO, t_tab, t_st, _t(weak),
                                       _t(strong), avg2num)
        assert _rel(ts.numpy(), js) <= FFT2_POWER
        assert _rel(tp.numpy(), jp) <= FFT2_POWER
        assert _rel(t_st.sumsq_avg.numpy(), j_st.sumsq_avg) <= FIELD
        np.testing.assert_array_equal(t_st.tail.numpy(),
                                      np.asarray(j_st.tail))
        tail, spec = tfft2.fft2_transform(T_GEO, t_tab, parts.tail,
                                          _t(weak), _t(strong))
        parts, power = tfft2.fft2_power_update(T_GEO, parts, tail, spec,
                                               avg2num)
        for a, b in ((ts, spec), (tp, power), (t_st.tail, parts.tail),
                     (t_st.sumsq_avg, parts.sumsq_avg)):
            assert _equal(a, b)
