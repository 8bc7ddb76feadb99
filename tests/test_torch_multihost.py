"""The port's multi-process sharded step (linrad_tpu_torch/parallel/
multihost.py over group.DistGroup), as tests/test_multihost.py runs the
JAX package's: two processes joined by torch.distributed with gloo on
127.0.0.1, each with 2 local CPU shards (a 4-shard global group), each
reading only its own rows of every step (host_rows) and handing them to
the sharded step through scatter_step_block.  The audio, the blanker
counts and the cross-process collectives are held against the same step
over LocalGroup(["cpu"] * 4) in this process: audio within 1e-6, counts
exact.  One process with 4 local shards (world size 1, every
torch.distributed call still made) is held the same way.

The workers are this file run as a script (the ``__main__`` block below).
The configuration has the blanker on, with strong pulses on every shard
edge, so that the halo exchange and the shipped-back corrections cross
the process boundary in both directions.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from linrad_tpu_torch import RxParams, derive_geometry
from linrad_tpu_torch.parallel import (LocalGroup, host_rows,
                                       scatter_step_block)
from linrad_tpu_torch.parallel.sharded import make_sharded_rx_step
from linrad_tpu_torch.pipeline.chain import RxState, RxTables
from linrad_tpu_torch.pipeline.receiver import _pulsewidth

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
SHARDS = 4
STEPS = 3
TUNE_BIN = 64


def params() -> RxParams:
    return RxParams(fft1_n_override=9, agc_enable=False,
                    target_fft1_frames_per_step=8, second_fft_enable=True,
                    blanker_enable=True, clever_bln_limit=6.0,
                    stupid_bln_limit=4.0, max_pulses_per_block=16,
                    shards=SHARDS)


def make_iq(geo) -> np.ndarray:
    rng = np.random.default_rng(5)
    n = geo.samples_per_step * STEPS
    t = np.arange(n) / geo.rx_ad_speed
    f = TUNE_BIN * geo.rx_ad_speed / geo.fftx_size + 250.0
    iq = (np.exp(2j * np.pi * f * t)
          + 0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n)))
    shard = geo.samples_per_step // SHARDS
    for s in range(STEPS):
        for b in range(1, SHARDS):
            iq[s * geo.samples_per_step + b * shard + s - 1] += 400.0
    return iq.astype(np.complex64)


def run_steps(group, iq: np.ndarray) -> dict:
    """The sharded step over ``group``, this process's rows of every step;
    the replicated audio and blanker counts."""
    p = params()
    geo = derive_geometry(p)
    tables = RxTables.create(geo, p, group.home)
    state = RxState.create(geo, group.home)
    step = make_sharded_rx_step(geo, p, group, _pulsewidth(geo),
                                tables=tables)
    lo, hi = host_rows(group, geo)
    tune = torch.tensor(TUNE_BIN, device=group.home)
    s = geo.samples_per_step
    audio, fitted = [], []
    for i in range(len(iq) // s):
        rows = scatter_step_block(group, geo,
                                  iq[i * s:(i + 1) * s, None][lo:hi])
        state, out = step(tables, state, rows, tune)
        audio.append(out.audio.numpy())
        fitted.append(int(out.blanker_fitted))
    return {"audio": np.concatenate(audio), "fitted": np.array(fitted),
            "rows": np.array([lo, hi])}


def collectives(group) -> dict:
    """Each collective on shard values 1, 2, 3, 4 (complex for the
    neighbour exchanges), as this process sees them."""
    xs = [torch.tensor([group.axis_index(i) + 1.0], dtype=torch.complex64)
          for i in range(group.n_local)]
    reals = [x.real.contiguous() for x in xs]
    return {"left": torch.cat(group.from_left(xs)).numpy(),
            "right": torch.cat(group.from_right(xs)).numpy(),
            "psum": group.psum(reals).numpy(),
            "pmean": group.pmean(reals).numpy(),
            "last": group.pick_last(reals).numpy(),
            "gather": group.all_gather(reals, 0).numpy()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(tmp_path, world: int) -> list[dict]:
    p = params()
    iq = make_iq(derive_geometry(p))
    iq_path = tmp_path / "iq.npy"
    np.save(iq_path, iq)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    outs = [tmp_path / f"out_{r}.npz" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, HERE, str(r), str(world), str(port), str(iq_path),
         str(outs[r])], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    logs = [pr.communicate(timeout=300)[0].decode() for pr in procs]
    for r, pr in enumerate(procs):
        assert pr.returncode == 0, f"worker {r}:\n{logs[r][-3000:]}"
    return [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module")
def local():
    """The same step over LocalGroup(["cpu"] * 4) in this process."""
    group = LocalGroup(["cpu"] * SHARDS)
    res = run_steps(group, make_iq(derive_geometry(params())))
    res.update(collectives(group))
    return res


def _check(got: dict, local: dict) -> None:
    np.testing.assert_allclose(got["audio"], local["audio"], atol=1e-6)
    np.testing.assert_array_equal(got["fitted"], local["fitted"])
    for k in ("psum", "pmean", "last", "gather"):
        np.testing.assert_array_equal(got[k], local[k], err_msg=k)


def test_two_processes_equal_local_group(tmp_path, local):
    """2 processes x 2 shards: each owns half the rows; the replicated
    audio agrees between them and with the one-process group; the
    neighbour values cross the process boundary, zeros at the ends."""
    w0, w1 = _spawn(tmp_path, 2)
    s = derive_geometry(params()).samples_per_step
    assert w0["rows"].tolist() == [0, s // 2]
    assert w1["rows"].tolist() == [s // 2, s]
    np.testing.assert_array_equal(w0["audio"], w1["audio"])
    for w in (w0, w1):
        _check(w, local)
        assert w["none_refused"]
    left = np.concatenate([w0["left"], w1["left"]])
    right = np.concatenate([w0["right"], w1["right"]])
    np.testing.assert_array_equal(left, local["left"])
    np.testing.assert_array_equal(right, local["right"])
    assert left.real.tolist() == [0, 1, 2, 3]
    assert right.real.tolist() == [2, 3, 4, 0]
    assert local["fitted"].sum() > 0


def test_one_process_dist_group_equals_local_group(tmp_path, local):
    """World size 1 with 4 local shards: the DistGroup makes its
    torch.distributed calls all the same, and gives the local result."""
    (w0,) = _spawn(tmp_path, 1)
    _check(w0, local)
    np.testing.assert_array_equal(w0["left"], local["left"])
    np.testing.assert_array_equal(w0["right"], local["right"])
    assert w0["rows"].tolist() == [0, derive_geometry(params())
                                   .samples_per_step]


def test_host_rows_and_scatter_in_one_process():
    """One process: host_rows spans the block; scatter_step_block splits a
    whole block over the shards (its rows in shard order); None rows are
    refused."""
    group = LocalGroup(["cpu"] * SHARDS)
    geo = derive_geometry(params())
    s = geo.samples_per_step
    assert host_rows(group, geo) == (0, s)
    block = make_iq(geo)[:s, None]
    parts = scatter_step_block(group, geo, block)
    assert len(parts) == SHARDS
    assert all(p.shape == (s // SHARDS, 1) and p.dtype == torch.complex64
               for p in parts)
    np.testing.assert_array_equal(torch.cat(parts).numpy(), block)
    with pytest.raises(ValueError, match="rows"):
        scatter_step_block(group, geo, None)


if __name__ == "__main__":
    import torch.distributed as dist

    from linrad_tpu_torch.parallel import global_time_mesh

    rank, world, port = (int(a) for a in sys.argv[1:4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    mesh = global_time_mesh(["cpu"] * (SHARDS // world))
    assert mesh.axis_size == SHARDS and mesh.rank == rank
    result = run_steps(mesh, np.load(sys.argv[4]))
    result.update(collectives(mesh))
    try:
        scatter_step_block(mesh, derive_geometry(params()), None)
        result["none_refused"] = False
    except ValueError:
        result["none_refused"] = True
    dist.barrier()
    dist.destroy_process_group()
    np.savez(sys.argv[5], **result)
    print(f"worker {rank}: ok rows {result['rows'].tolist()}", flush=True)
