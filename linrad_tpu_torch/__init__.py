"""linrad_tpu_torch — the PyTorch/CUDA port of linrad_tpu.

The JAX package ``linrad_tpu`` stays the reference.  This package takes
the same ``RxParams``/``Geometry`` (shared from ``linrad_tpu``'s jax-free
configuration modules, not copied) and returns the same ``RxOutputs``
fields, in PyTorch, with the TPU's Pallas kernel rewritten as a CUDA
kernel for Hopper (``csrc/fused_fft1.cu``).

Ported so far: the flagship receive step, ``pipeline.chain.make_rx_step``
and ``pipeline.receiver.Receiver``, for single-channel IQ with SSB
demodulation.  Configurations off that slice raise NotImplementedError
naming the ROADMAP entry that ports them.

This package never imports jax.
"""

from linrad_tpu import (Demod, Geometry, InputMode, RxMode, RxParams,
                        derive_geometry, preset)

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
