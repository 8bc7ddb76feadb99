"""End-to-end demo: weak CW in noise and pulses -> decoded text (twin of
examples/demo_rx.py on this package).

Synthesises the kind of signal Linrad was built for (weak keyed CW with
impulse noise, the EME/weak-signal use case), runs the full wideband +
narrowband chain with both blankers on the card, decodes the Morse on
the host, and writes waterfall/audio artifacts.

    python -m linrad_tpu_torch.examples.demo_rx [out_dir] [--device cpu]
"""

from __future__ import annotations

import os

import numpy as np

from linrad_tpu_torch import RxParams
from linrad_tpu_torch.examples._args import TINY, parse
from linrad_tpu_torch.io.siggen import gaussian_noise, impulse_noise
from linrad_tpu_torch.io.wav import write_wav
from linrad_tpu_torch.pipeline import Receiver
from linrad_tpu_torch.utils.host import to_numpy
from linrad_tpu_torch.utils.timing import StepTimer
from linrad_tpu_torch.viz import Waterfall, save_pgm
from linrad_tpu_torch.weak.cw import decode_morse, decode_morse_ml, keyed_cw


def main(out_dir: str = "demo_rx_out", *, device="cuda",
         tiny: bool = False) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    kw = dict(
        first_fft_bandwidth=100.0,
        mix1_bandwidth_reduction_n=4,
        second_fft_enable=True,
        blanker_enable=True,
        clever_bln_limit=6.0,
        stupid_bln_limit=4.0,
        max_pulses_per_block=64,
        agc_enable=True,
        bfo_hz=700.0,
        filter_low_hz=-400.0,
        filter_high_hz=400.0,
    )
    p = RxParams(**{**kw, **(TINY if tiny else {})})
    rx = Receiver(p, device=device)
    g = rx.geo
    fs = g.rx_ad_speed
    print(f"geometry: fft1={g.fft1_size} fft2={g.fft2_size} "
          f"mix1={g.mix1_size} fs_bb={g.baseband_sampling_speed:.0f} Hz "
          f"step={g.samples_per_step} samples; device {rx.device}")

    msg = "TEST" if tiny else "CQ CQ DE SM5BSZ SM5BSZ K"
    cw = keyed_cw(msg, fs, wpm=40 if tiny else 18, tone_hz=12_000.0,
                  amplitude=0.2)
    pad = (-len(cw)) % g.samples_per_step
    cw = np.concatenate([cw, np.zeros(pad, np.complex64)])
    rng = np.random.default_rng(7)
    iq = (cw + gaussian_noise(rng, len(cw), level_bits=-9)
          + impulse_noise(rng, len(cw), rate_hz=40.0, fs=fs,
                          amplitude=10.0))
    print(f"signal: {len(iq)/fs:.1f} s of 96 kHz IQ, CW at 0.2 amp, "
          f"noise + 40 pulses/s at 50x signal amplitude")

    rx.tune(12_000.0)
    wf = Waterfall(n_bins=g.fft2_size, depth=512)
    timer = StepTimer(fs, g.samples_per_step)
    audio = []
    fitted = 0
    s = g.samples_per_step
    for blk in range(len(iq) // s):
        timer.start()
        out = rx.process_block(iq[blk * s:(blk + 1) * s, None])
        timer.stop(out.audio)
        audio.append(to_numpy(out.audio))
        fitted += int(out.blanker_fitted)
        wf.add(out.fft2_power)
    audio = np.concatenate(audio)[:, 0]
    print(f"throughput: {timer.report()}")
    print(f"blanker: {fitted} pulses subtracted")

    res = decode_morse(audio, g.baseband_sampling_speed)
    print(f"decoded (matched-filter) @ {res.wpm:.0f} WPM: {res.text!r}")
    res_ml = decode_morse_ml(audio, g.baseband_sampling_speed)
    print(f"decoded (ML grammar)     @ {res_ml.wpm:.0f} WPM:"
          f" {res_ml.text!r}")
    print("expected:", repr(msg))

    write_wav(f"{out_dir}/audio.wav",
              (audio * 20_000)[:, None].astype(np.float32),
              int(g.baseband_sampling_speed))
    save_pgm(f"{out_dir}/waterfall.pgm", wf.image())
    print(f"artifacts in {out_dir}: audio.wav, waterfall.pgm")
    return {"text": res.text, "text_ml": res_ml.text, "expected": msg,
            "steps": len(audio) // g.baseband_samples_per_step}


if __name__ == "__main__":
    a = parse(__doc__, ("out_dir", str, "demo_rx_out"))
    main(a.out_dir, device=a.device, tiny=a.tiny)
