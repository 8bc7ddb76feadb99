"""The seam every hand kernel of the port goes through,
``utils/cuda_build.py``, held for each kernel it lists.

For each source ``csrc/<name>.cu``: it is one of ``cuda_build.KERNELS``,
its module registers its launch count, and ``trace.report()`` reads that
count; its operator's call on a CPU tensor is the plain version's bits and
counts no launch; a tensor on a device that is neither the CPU nor CUDA is
refused by the operator's dispatch, naming the operator.  The one counting
path, ``cuda_build.launch``, sends a launch to ``captured`` during a CUDA
graph's capture and to ``launches`` outside one.

This file imports no JAX and needs nothing of ``tests/conftest.py``.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from linrad_tpu_torch.ops import blanker as bl
from linrad_tpu_torch.ops import fused_fft1 as ff
from linrad_tpu_torch.ops import mix1 as mx
from linrad_tpu_torch.ops import sellim as sl
from linrad_tpu_torch.utils import cuda_build, trace
from linrad_tpu_torch.weak import radar as rd

SOURCES = sorted(p.stem for p in cuda_build.CSRC.glob("*.cu"))


def _fft1_args() -> tuple:
    rng = np.random.default_rng(3)
    frames = (rng.normal(size=(8, 256, 2))
              + 1j * rng.normal(size=(8, 256, 2))).astype(np.complex64)
    window = np.sin(np.pi * (np.arange(256) + 0.5) / 256) ** 2
    fc = (1.0 + 0.1j * rng.normal(size=(256, 2))).astype(np.complex64)
    return (torch.from_numpy(frames),
            torch.from_numpy(window.astype(np.float32)), torch.from_numpy(fc))


# kernel -> (operator's name, operator, plain version, its CPU arguments)
CASES = {
    "fused_fft1": ("fused_fft1", ff.fused_fft1, ff.fused_fft1_reference,
                   _fft1_args),
    "blanker_fits": ("blanker_fits", bl.blanker_fits,
                     bl._blanker_fits_reference,
                     lambda: cs.fits_edge_args("plain", "cpu")),
    "blanker_clear": ("blanker_clear", bl.blanker_clear,
                      bl._blanker_clear_reference,
                      lambda: cs.clear_edge_args("long-run", "cpu")),
    "sellim_taper": ("sellim_taper", sl.sellim_taper,
                     sl._sellim_taper_reference,
                     lambda: cs.taper_edge_args("tie", "cpu")),
    "sellim_update": ("sellim_update", sl.sellim_update,
                      sl._update_liminfo_reference,
                      lambda: cs.update_edge_args("history", "cpu")),
    "mix1_ramp": ("mix1_ramp", mx.mix1_ramp, mx._frac_ramp_reference,
                  lambda: cs.ramp_args((4096, 8, True, True), "cpu")),
    "radar_stats": ("frame_pulse_stats", rd.frame_pulse_stats,
                    rd._frame_pulse_stats_reference,
                    lambda: (torch.from_numpy(cs.stats_case("skirts", 8,
                                                            256)), 32)),
}


class Elsewhere(torch.Tensor):
    """A tensor that says it lives on an XPU device.  Its operations run
    their kernels as they would for a tensor of that device, so that a
    custom operator's body sees the device."""

    @staticmethod
    def __new__(cls, t: torch.Tensor):
        return torch.Tensor._make_wrapper_subclass(
            cls, t.shape, dtype=t.dtype, device="xpu", strides=t.stride())

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        python = (torch._C.DispatchKeySet(torch._C.DispatchKey.Python)
                  | torch._C.DispatchKeySet(
                      torch._C.DispatchKey.PythonTLSSnapshot))
        with torch._C._ExcludeDispatchKeyGuard(python):
            return func(*args, **(kwargs or {}))


def _counts(kernel: str) -> tuple[int, int]:
    count = cuda_build.COUNTS[kernel]
    return count.launches, count.captured


def _bits(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x) if x.is_complex() else x


@pytest.mark.parametrize("kernel", SOURCES)
def test_source_is_a_kernel_with_a_count(kernel):
    """Every csrc/*.cu is in KERNELS, has its case here, and its launch
    count is in the tracer's report."""
    assert kernel in cuda_build.KERNELS and kernel in CASES
    launches = trace.report()["counters"]["launches"]
    assert launches[kernel] == list(_counts(kernel))


def test_kernels_are_the_sources():
    assert cuda_build.KERNELS == tuple(SOURCES) and set(CASES) == set(SOURCES)


@pytest.mark.parametrize("kernel", sorted(CASES))
def test_cpu_call_is_the_plain_version_and_counts_nothing(kernel):
    _name, op, plain, make = CASES[kernel]
    args = make()
    before = _counts(kernel)
    got, want = op(*args), plain(*args)
    assert _counts(kernel) == before
    got, want = ((got,), (want,)) if isinstance(got, torch.Tensor) \
        else (got, want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("kernel", sorted(CASES))
def test_unsupported_device_is_refused(kernel):
    name, op, _plain, make = CASES[kernel]
    args = [Elsewhere(x) if isinstance(x, torch.Tensor) else x
            for x in make()]
    assert args[0].device.type == "xpu"
    with pytest.raises(ValueError, match=f"^{name}: unsupported device xpu"):
        op(*args)


@pytest.mark.parametrize("capturing", [False, True])
def test_launch_counts_by_capture(monkeypatch, capturing):
    """One launch that returns 0 goes to ``captured`` during a capture and
    to ``launches`` outside one; the launcher is handed the stream last;
    a launch that returns an error raises and counts nothing."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(cuda_build, "raw_stream", lambda device: 77)
    calls = []

    def fn(*args):
        calls.append(args)
        return 0 if len(calls) == 1 else 9

    count = cuda_build.LaunchCount()
    count.launches = count.captured = 0
    dev = torch.device("cuda", 0)
    cuda_build.launch(fn, (1, 2), dev, "probe", count)
    assert calls == [(1, 2, 77)]
    assert (count.launches, count.captured) == ((0, 1) if capturing
                                                else (1, 0))
    with pytest.raises(RuntimeError, match="probe: kernel launch failed "
                                           "with CUDA error 9"):
        cuda_build.launch(fn, (1, 2), dev, "probe", count)
    assert (count.launches, count.captured) == ((0, 1) if capturing
                                                else (1, 0))
