"""linrad_tpu_torch — the PyTorch/CUDA port of linrad_tpu.

The JAX package ``linrad_tpu`` stays the reference.  This package keeps
its own copies of the modules that need no JAX (``params``, ``geometry``,
``ops.windows``, ``utils.llsq``, ``weak.afc``, ``errors``, ``io.wav``,
``io.siggen``, ``io.rawfile``, ``runtime`` with its C++ library,
``calibration``), imports nothing of ``linrad_tpu``, and returns the same
``RxOutputs`` fields, in PyTorch, with the TPU's Pallas kernel rewritten
as a CUDA kernel for Hopper (``csrc/fused_fft1.cu``).

Ported so far: the whole receive chain, ``pipeline.chain.make_rx_step``
and ``make_multi_rx_step`` with ``pipeline.receiver.Receiver`` and
``MultiReceiver`` (K sub-receivers over one wideband front end): IQ or
real input with one or two channels, I/Q image correction, both
blankers, spur cancellation, both mixer modes, adaptive polarization, the
SSB, AM, FM and coherent detectors, AGC, expander, squelch, the audio
resampler, and the host-side AFC and spur manager
(``pipeline.control``); and the host layer around it:
``pipeline.batch.BatchRunner`` (K steps per call, the step captured into
a CUDA graph by ``GraphedStep``), ``pipeline.checkpoint`` (save and
resume), ``pipeline.latency`` (the latency budget), ``Receiver.run_file``
(WAV replay through ``runtime.FilePrefetcher``), ``runtime.watchdog``,
the step timers of ``utils.timing``, ``ops.demod.wfm_stereo_decode`` and
the radar tracker ``weak.radar``; the round-parallel clever blanker
(``blanker_rounds>0``), the matmul-DFT fft1 variants (``"mxu"``,
``"mxu_bf16"``), the calibration module (``calibration``, a copy) and
``parallel.FleetRunner`` (many receivers as one ``torch.func.vmap``'d
step, one fused fft1 launch for all of them).  ``shards>1`` raises
NotImplementedError naming its ROADMAP entry; the time-sharded steps,
the transmit side and the display and network modules are still to
come.

This package never imports jax or ``linrad_tpu``;
``convert.params_from_jax`` turns the JAX package's ``RxParams`` into
this package's.
"""

from .geometry import Geometry, derive_geometry
from .params import Demod, InputMode, RxMode, RxParams, preset

__all__ = ["Demod", "Geometry", "InputMode", "RxMode", "RxParams",
           "derive_geometry", "flagship_params", "preset"]


def flagship_params(tiny: bool = False,
                    fft1_variant: str | None = "pallas") -> RxParams:
    """The repository's flagship receive configuration (the parameters of
    ``__graft_entry__._flagship_params``): 96 kHz single-channel IQ,
    65,536 samples per step, 2048-point fft1, second FFT on, both
    blankers, SSB and AGC.  ``fft1_variant="pallas"`` selects the fused
    fft1 kernel.  ``tiny`` cuts it to fft1 256 and 1,024 samples per step
    for tests."""
    kw = dict(rx_ad_speed=96_000, first_fft_bandwidth=100.0,
              mix1_bandwidth_reduction_n=4, second_fft_enable=True,
              blanker_enable=True, agc_enable=True, clever_bln_limit=6.0,
              stupid_bln_limit=4.0, max_pulses_per_block=64,
              fft1_variant=fft1_variant)
    if tiny:
        kw.update(fft1_n_override=8, target_fft1_frames_per_step=8,
                  fft3_n=6, max_pulses_per_block=8)
    return RxParams(**kw)
