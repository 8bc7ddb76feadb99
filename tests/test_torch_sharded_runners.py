"""The port's sharded runners and collectives (harness and bars:
tests/test_torch_sharded.py).

- ShardedMultiReceiver at K = 3 with the blanker against the JAX
  package's on four virtual CPU devices, from the same tables and states.
- ShardedBatchRunner (K = 3 steps a call, blanker_rounds=4, as
  tests/test_sharded.py's TestShardedBatch) against the JAX package's,
  and against the port's streamed ShardedReceiver bit for bit.
- The collectives of LocalGroup on their own: the edge shards' zeros,
  the shard order of sums and gathers, and the scatter of a block.
"""

import numpy as np
import jax
import pytest
import torch

from linrad_tpu import RxParams
from linrad_tpu.io.siggen import Tone, impulse_noise, tones_iq
from linrad_tpu.parallel import ShardedBatchRunner as JaxShardedBatchRunner
from linrad_tpu.parallel import ShardedMultiReceiver as JaxShardedMulti
from linrad_tpu_torch import convert
from linrad_tpu_torch.parallel import (LocalGroup, ShardedBatchRunner,
                                       ShardedMultiReceiver,
                                       ShardedReceiver)
from test_torch_sharded import (BARS, D, FIELDS, OTHER_BAR, WIDE, base,
                                max_rel, noise)

K_SUB = 3
DIALS = (12_000.0, 20_000.0, 33_000.0)


def _wideband_input(geo, steps: int, seed: int, tones) -> np.ndarray:
    rng = np.random.default_rng(seed)
    fs = geo.rx_ad_speed
    n = geo.samples_per_step * steps
    return (tones_iq(fs, n, [Tone(f) for f in tones]) + noise(rng, n)
            + impulse_noise(rng, n, 50.0, fs, 30.0))


@pytest.fixture(scope="module")
def multi():
    jp = RxParams(**base(**WIDE), shards=D)
    jmx = JaxShardedMulti(jp, n_subch=K_SUB, devices=jax.devices()[:D])
    tmx = ShardedMultiReceiver(convert.params_from_jax(jp), K_SUB,
                               ["cpu"] * D)
    tmx.tables = convert.tables_from_numpy(convert.flatten(jmx.tables),
                                           "cpu")
    tmx.state = convert.state_from_numpy(convert.flatten(jmx.state), "cpu")
    tmx.nbs = convert.nbstate_from_numpy(convert.flatten(jmx.nbs), "cpu")
    for k, f in enumerate(DIALS):
        jmx.tune_subch(k, f)
        tmx.tune_subch(k, f)
    iq = _wideband_input(jmx.geo, 4, 4, [f + 250.0 for f in DIALS])
    j_out = list(jmx.run(iq))
    t_out = list(tmx.run(iq))
    return jp, jmx, tmx, j_out, t_out


@pytest.mark.parametrize("field", FIELDS)
def test_multi_against_jax(multi, field):
    _jp, _jmx, _tmx, j_out, t_out = multi
    jv = [getattr(o, field) for o in j_out]
    tv = [getattr(o, field) for o in t_out]
    for a, b in zip(tv, jv):
        assert tuple(a.shape) == tuple(np.shape(b)), field
    if field in ("blanker_fitted", "blanker_cleared"):
        assert [int(v) for v in tv] == [int(v) for v in jv]
        return
    t_arr = np.stack([v.numpy() for v in tv])
    j_arr = np.stack([np.asarray(v) for v in jv])
    if field == "liminfo":
        np.testing.assert_array_equal(np.sign(t_arr), np.sign(j_arr))
    if field in ("audio", "baseb", "agc_gain"):
        assert t_arr.shape[1] == K_SUB
    assert max_rel(t_arr, j_arr) <= BARS.get(field, OTHER_BAR), field


def test_multi_state_against_jax(multi):
    """The wideband state and the K stacked narrowband states."""
    _jp, jmx, tmx, j_out, _t = multi
    for ref, port in ((convert.flatten(jmx.state),
                       convert.state_to_numpy(tmx.state)),
                      (convert.flatten(jmx.nbs),
                       convert.state_to_numpy(tmx.nbs))):
        assert sorted(port) == sorted(ref)
        for k, v in port.items():
            if v.dtype.kind in "iub":
                np.testing.assert_array_equal(v, ref[k], err_msg=k)
            else:
                assert max_rel(v, ref[k]) <= OTHER_BAR, k
    assert sum(int(o.blanker_fitted) for o in j_out) > 0
    assert tmx.nbs.mix1.phase_idx.shape == (K_SUB,)


BATCH = dict(base(**WIDE), blanker_rounds=4)


@pytest.fixture(scope="module")
def batches():
    jp = RxParams(**BATCH, shards=D)
    tp = convert.params_from_jax(jp)
    jbr = JaxShardedBatchRunner(jp, k_steps=3, outputs=("audio", "baseb"),
                                devices=jax.devices()[:D])
    tbr = ShardedBatchRunner(tp, k_steps=3, outputs=("audio", "baseb"),
                             devices=["cpu"] * D)
    tbr.tables = convert.tables_from_numpy(convert.flatten(jbr.tables),
                                           "cpu")
    tbr.state = convert.state_from_numpy(convert.flatten(jbr.state), "cpu")
    jbr.tune(12_000.0)
    tbr.tune(12_000.0)
    iq = _wideband_input(jbr.geo, 6, 1, [12_400.0])
    # 100 samples more than two calls take: dropped
    return (jp, tp, jbr, tbr, iq, jbr.process(iq),
            tbr.process(np.concatenate([iq, iq[:100]])))


@pytest.mark.parametrize("field", ["audio", "baseb"])
def test_batch_against_jax(batches, field):
    _jp, _tp, jbr, _tbr, _iq, j_out, t_out = batches
    bb = jbr.geo.baseband_samples_per_step
    assert t_out[field].shape == j_out[field].shape == (6 * bb, 1)
    assert max_rel(t_out[field], j_out[field]) <= BARS.get(field, OTHER_BAR)


def test_batch_equals_streamed(batches):
    """K steps a call chain the state exactly as streamed steps do, bit
    for bit; the state after the call is the streamed receiver's."""
    _jp, tp, _jbr, tbr, iq, _j, t_out = batches
    srx = ShardedReceiver(tp, ["cpu"] * D)
    srx.tune(12_000.0)
    outs = list(srx.run(iq))
    for f in ("audio", "baseb"):
        ref = torch.cat([getattr(o, f) for o in outs]).numpy()
        np.testing.assert_array_equal(t_out[f], ref)
    assert sum(int(o.blanker_fitted) for o in outs) > 0
    assert tbr.samples_per_call == 3 * srx.geo.samples_per_step
    ref = convert.state_to_numpy(srx.state)
    for k, v in convert.state_to_numpy(tbr.state).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


def test_local_group_collectives():
    """Neighbour values with zeros at the edges, the last shard's value,
    sums and gathers in shard order, a block split over the shards."""
    g = LocalGroup(["cpu"] * 4)
    xs = [torch.full((2, 1), float(i + 1)) for i in range(4)]
    assert [float(x[0, 0]) for x in g.from_left(xs)] == [0, 1, 2, 3]
    assert [float(x[0, 0]) for x in g.from_right(xs)] == [2, 3, 4, 0]
    assert float(g.pick_last(xs)[0, 0]) == 4.0
    assert float(g.psum(xs)[0, 0]) == 10.0
    assert float(g.pmean(xs)[0, 0]) == 2.5
    gathered = g.all_gather(xs, dim=0)
    assert gathered[:, 0].tolist() == [1, 1, 2, 2, 3, 3, 4, 4]
    c = [torch.tensor([1 + 1j], dtype=torch.complex64) * i for i in range(4)]
    assert torch.equal(g.from_left(c)[0],
                       torch.zeros(1, dtype=torch.complex64))
    # float sums in shard order: ((a + b) + c) + d, whatever the devices
    vals = [torch.tensor(v, dtype=torch.float32)
            for v in (1e8, 1.0, -1e8, 1.0)]
    assert float(g.psum(vals)) == float(((vals[0] + vals[1]) + vals[2])
                                        + vals[3])
    block = torch.arange(8.0)[:, None]
    parts = g.scatter(block, 0)
    assert [p[:, 0].tolist() for p in parts] == [[0, 1], [2, 3], [4, 5],
                                                 [6, 7]]
    with pytest.raises(ValueError, match="shards"):
        g.scatter(torch.zeros(6, 1), 0)
    assert [g.axis_index(i) for i in range(4)] == [0, 1, 2, 3]
    assert g.axis_size == 4


def test_sharded_receiver_refusals():
    """A geometry whose frames do not split over the shards is refused;
    with no device list and no CUDA device the receiver raises."""
    from linrad_tpu_torch.parallel.sharded import make_sharded_rx_step
    from linrad_tpu_torch import derive_geometry
    tp = convert.params_from_jax(RxParams(**base(), shards=1))
    geo = derive_geometry(tp)
    with pytest.raises(ValueError, match="shards"):
        make_sharded_rx_step(geo, tp, LocalGroup(["cpu"] * 3))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ShardedReceiver(tp)
