"""Multi-sub-receiver demo: one wideband front end, K independently
tuned sub-receivers (twin of examples/demo_multirx.py on this package).

The form of the reference's MIX1_NO_OF_CHANNELS=24 mix1 channel slots
and of its network "userx" consumers (a master multicasting the wideband
pipeline to narrowband slaves, globdef.h:315/1282-1294, z_NETWORK.txt):
instead of fanning stages out over UDP to separate machines, the
sub-receivers are a batch axis of one step on the card.

    python -m linrad_tpu_torch.examples.demo_multirx [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np

from linrad_tpu_torch import Demod, RxParams
from linrad_tpu_torch.examples._args import TINY, parse
from linrad_tpu_torch.io.siggen import Tone, gaussian_noise, tones_iq
from linrad_tpu_torch.pipeline import MultiReceiver
from linrad_tpu_torch.utils.host import to_numpy


def main(*, device="cuda", tiny: bool = False) -> dict:
    p = RxParams(first_fft_bandwidth=100.0,
                 mix1_bandwidth_reduction_n=4, demod=Demod.SSB,
                 bfo_hz=800.0, **(TINY if tiny else {}))
    n_subch = 3 if tiny else 8
    mrx = MultiReceiver(p, n_subch=n_subch, device=device)
    g = mrx.geo

    # a band with one station per sub-receiver
    rng = np.random.default_rng(7)
    stations = [6_000.0 + 4_000.0 * k for k in range(n_subch)]
    n = g.samples_per_step * 8
    iq = tones_iq(g.rx_ad_speed, n,
                  [Tone(f + 400.0, amplitude=10 ** (-k / 8))
                   for k, f in enumerate(stations)])
    iq = (iq + gaussian_noise(rng, n, level_bits=-12)).astype(np.complex64)

    for k, f in enumerate(stations):
        mrx.tune_subch(k, f)

    t0 = time.time()
    audio = np.concatenate([to_numpy(out.audio) for out in mrx.run(iq)],
                           axis=1)                       # (K, S, C)
    dt = time.time() - t0

    print(f"{n_subch} sub-receivers x {n / g.rx_ad_speed:.2f}s of band "
          f"in {dt:.2f}s wall on {mrx.device}")
    peaks = []
    for k in range(n_subch):
        a = audio[k, audio.shape[1] // 3:, 0]
        spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
        fpk = np.fft.rfftfreq(len(a), 1 / g.baseband_sampling_speed)[
            np.argmax(spec)]
        peaks.append(float(fpk))
        print(f"  subch {k}: tuned {stations[k]/1e3:7.1f} kHz -> "
              f"audio peak {fpk:6.1f} Hz, rms {a.std():.3f}")
    return {"audio_shape": audio.shape, "peaks_hz": peaks}


if __name__ == "__main__":
    a = parse(__doc__)
    main(device=a.device, tiny=a.tiny)
