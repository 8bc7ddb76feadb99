"""Error system — numeric codes with text, raised as exceptions.

The reference maps numeric error codes to text from errors.lir (1210
lines) and any thread calling ``lirerr(code)`` triggers an orderly
teardown (lxsys.c:495-505, thread_kill_all :784).  In a functional
pipeline errors are exceptions; the numeric-code surface is kept for
familiarity and for the codes the tests/tools reference."""

from __future__ import annotations

ERROR_TEXT = {
    # The DSP-relevant subset of the reference's errors.lir catalog:
    # every code below is raised by a translation unit of the DSP core
    # (the same set the refharness compiles); the remaining ~1090
    # errors.lir entries are GUI, soundcard, device-setup and Windows
    # texts with no analog in a headless accelerator pipeline.  Texts are summarised;
    # the numeric codes are the compatibility contract.
    937: "FFT size larger than 65536 (check fft1 version/size derivation)",
    999: "reached a cwdetect.c path whose code was never written",
    1002: "buffers already allocated (get_buffers re-entered)",
    1003: "failed to allocate scratch memory",
    1050: "calibration symmetry fit failed (make_symfit)",
    1051: "linear least-squares solve failed (llsq)",
    1052: "filter-correction init failed (init_fft1_filtercorr)",
    1053: "I/Q fold-correction init failed (init_foldcorr)",
    1054: "calibration RAM update failed (cal_update_ram)",
    1057: "fft1 display endpoints out of range (set_fft1_endpoints)",
    1061: "out of memory for blanker arrays (init_blanker)",
    1103: "spur template bank init failed (init_spur_spectra)",
    1105: "spur complex lowpass invalid size (complex_lowpass)",
    1116: "failed to write calibration file",
    1161: "too few points in calibration data",
    1162: "calibration data is zero",
    1164: "could not open parameter file",
    1189: "insufficient allocation for Morse decode",
    1202: "calibration file corrupted (remove dsp_*_corr and redo)",
    1209: "a processing thread failed to start in time",
    1211: "first-mixer frequency below range (mix1)",
    1212: "first-mixer frequency above range (mix1)",
    1225: "calibration procedure failed: data out of range",
    1240: "internal memory error (arena canary tripped)",
    1241: "timf1 allocation too small for fft1",
    1259: "calibration response invalid (desired response is zero)",
    1450: "input thread did not become active (no input device/data)",
    1455: "accelerator FFT plan creation failed",
    1458: "OpenCL selected but not active",
    1459: "OpenCL selected but support not compiled in",
    1460: "CUDA selected but support not compiled in",
    1477: "baseband sampling rate too low to initialise the decoder",
    3001: "Morse decode consistency check failed (check_cw)",
    # framework-specific codes start at 9000
    9001: "input block size does not match samples_per_step",
    9002: "geometry not divisible by the requested shard count",
    9003: "calibration table size does not match fft1_size",
    9004: "unsupported raw-file bit depth",
    9005: "processing stalled (watchdog heartbeat timeout)",
    9006: "input overrun: data lost faster than it could be consumed",
    9007: "processing is slower than real time (margin exhausted)",
}


class LirError(RuntimeError):
    """lirerr() analog: numeric code + text."""

    def __init__(self, code: int, extra: str = ""):
        self.code = code
        text = ERROR_TEXT.get(code, "unknown error")
        super().__init__(f"error {code}: {text}"
                         + (f" ({extra})" if extra else ""))


def lirerr(code: int, extra: str = "") -> None:
    raise LirError(code, extra)
