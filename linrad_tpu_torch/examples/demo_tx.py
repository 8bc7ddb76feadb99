"""TX-chain demo: mic audio -> speech processor -> SSB -> self-analysis
(twin of examples/demo_tx.py on this package).

Exercises the transmit side end-to-end (the reference's TX + MODE_TXTEST
surface, tx.c / txssb.c / txtest.c): synthetic two-tone "mic" audio runs
through the SSB speech processor, is modulated to an SSB IQ stream,
analysed with txtest (IMD3, occupied bandwidth), then streamed through
the live SSB transmitter, whose resampler to the D/A rate runs on the
card; a CW identification with shaped keying plus a radar pulse train
round out the keying paths.

    python -m linrad_tpu_torch.examples.demo_tx [out_dir] [--device cpu]
"""

from __future__ import annotations

import os

import numpy as np

from linrad_tpu_torch.examples._args import parse
from linrad_tpu_torch.io.wav import write_wav
from linrad_tpu_torch.modes import powtim, txtest
from linrad_tpu_torch.tx import (SsbTxStreamer, ascii_keying, cw_envelope,
                                 radar_pulse_train, ssb_modulate)
from linrad_tpu_torch.tx.ssbproc import SSBProcessor


def main(out_dir: str = "demo_tx_out", *, device="cuda",
         tiny: bool = False) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    fs = 8000.0
    seconds = 1.0 if tiny else 4.0

    # --- SSB voice path: two-tone test signal through the processor ---
    t = np.arange(int(seconds * fs)) / fs
    mic = (0.4 * np.sin(2 * np.pi * 700.0 * t)
           + 0.4 * np.sin(2 * np.pi * 1900.0 * t)).astype(np.float64)
    proc = SSBProcessor(fs)
    shaped = proc.process(mic)
    tx_iq = ssb_modulate(shaped, fs, usb=True)
    res = txtest(tx_iq, fs)
    print(f"SSB two-tone: carrier {res.carrier_hz:+.0f} Hz, "
          f"occupied BW {res.occupied_bw_hz:.0f} Hz, "
          f"IMD3 {res.imd3_db:.1f} dBc")
    write_wav(f"{out_dir}/ssb_iq.wav",
              np.stack([tx_iq.real, tx_iq.imag], 1).astype(np.float32)
              * 20000, int(fs))

    # --- the same mic streamed live: blocks to the D/A rate on the card ---
    block = 1024
    tx = SsbTxStreamer(fs, 4 * fs, block, device=device)
    tx.push_mic(mic.astype(np.float32))
    delay = tx.total_delay()
    tx.pump()
    out = []
    while (b := tx.pop_dac()) is not None:
        out.append(b)
    dac = np.concatenate(out)
    print(f"SSB stream: {len(out)} blocks of {block} mic samples -> "
          f"{len(dac)} D/A samples at {4 * fs:.0f} Hz on {tx.device}, "
          f"mic-to-antenna delay {1e3 * delay:.1f} ms before the pump")

    # --- CW identification with rise-time-shaped keying ---
    key = ascii_keying("TEST DE SM5BSZ", fs, wpm=20)
    env = cw_envelope(key, fs, rise_s=0.005)
    cw_iq = (env * np.exp(2j * np.pi * 600.0 * np.arange(len(env)) / fs)
             ).astype(np.complex64)
    times, power = powtim(cw_iq, fs)
    duty = float(np.mean(power > 0.5 * power.max()))
    print(f"CW id: {len(env)/fs:.1f} s, keying duty {duty:.2f}, "
          f"power-vs-time windows {len(times)}")

    # --- radar pulse train (EME radar mode TX) ---
    train = radar_pulse_train(fs, prf_hz=10.0, pulse_s=0.01,
                              duration_s=2.0)
    print(f"radar train: {len(train)/fs:.1f} s, "
          f"~{int(round(train.sum() / (0.01 * fs)))} pulses")
    print(f"artifacts in {out_dir}: ssb_iq.wav")
    return {"imd3_db": res.imd3_db, "dac_samples": len(dac),
            "duty": duty}


if __name__ == "__main__":
    a = parse(__doc__, ("out_dir", str, "demo_tx_out"))
    main(a.out_dir, device=a.device, tiny=a.tiny)
