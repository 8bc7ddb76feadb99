"""Production receiver serving pattern (twin of examples/serve_rx.py on
this package).

Wires the pieces a deployed station uses: streamed ingest -> the receive
chain on the card (AFC engaged) -> web GUI (waterfall/spectrum/live audio
over HTTP) with the failure-detection surfaces (heartbeat watchdog,
real-time margin, S-meter log) attached — the linrad "run it all day"
configuration as a short script.

    python -m linrad_tpu_torch.examples.serve_rx [port] [wav] [--device cpu]

Generates a drifting CW signal by default; give a .wav path as the
second argument to serve a recording instead.  The GUI listens on
127.0.0.1 only.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from linrad_tpu_torch import RxParams, derive_geometry
from linrad_tpu_torch.examples._args import TINY, parse
from linrad_tpu_torch.io.httpd import WebGui
from linrad_tpu_torch.io.wav import read_wav
from linrad_tpu_torch.pipeline import Receiver
from linrad_tpu_torch.runtime.watchdog import RealTimeMonitor, Watchdog
from linrad_tpu_torch.utils.host import to_numpy
from linrad_tpu_torch.viz import SMeterLogger


def main(port: int = 8765, wav: str | None = None, *, device="cuda",
         tiny: bool = False) -> dict:
    p = RxParams(first_fft_bandwidth=30.0, mix1_bandwidth_reduction_n=4,
                 afc_enable=True, filter_low_hz=-250.0,
                 filter_high_hz=250.0, **(TINY if tiny else {}))
    geo = derive_geometry(p)
    rx = Receiver(p, audio_out_rate=None if tiny else 48_000.0,
                  device=device)
    fc = 10_000.0
    rx.tune(fc)

    if wav is not None:
        iq, info = read_wav(wav)
        if info.sample_rate != geo.rx_ad_speed:
            raise ValueError(f"{wav}: {info.sample_rate} Hz, the receiver "
                             f"takes {geo.rx_ad_speed} Hz")
    else:  # drifting carrier + noise, 20 s (40 steps when tiny)
        step_s = geo.samples_per_step / geo.rx_ad_speed
        n = geo.samples_per_step * (40 if tiny else int(20 / step_s))
        t = np.arange(n) / geo.rx_ad_speed
        rng = np.random.default_rng(1)
        iq = (0.3 * np.exp(2j * np.pi * (fc * t + 1.0 * t ** 2 / 2))
              + 0.05 * (rng.normal(size=n) + 1j * rng.normal(size=n))
              ).astype(np.complex64)

    gui = WebGui(audio_rate=48_000, n_bins=geo.fft1_size)
    gui.attach(rx)
    port = gui.serve(port=port)
    print(f"web GUI: http://localhost:{port}/")

    wd = Watchdog(timeout_s=30.0)
    wd.start(lambda names: print(f"WATCHDOG: stalled {names}"))
    mon = RealTimeMonitor(rate_hz=geo.rx_ad_speed, headroom_s=2.0)
    fd, smeter_path = tempfile.mkstemp(suffix=".smeter")
    os.close(fd)
    smeter = SMeterLogger(
        smeter_path,
        step_seconds=geo.samples_per_step / geo.rx_ad_speed)

    steps = 0
    try:
        for out in rx.run(iq, watchdog=wd, monitor=mon):
            smeter.add(float(np.mean(np.abs(to_numpy(out.baseb)) ** 2)))
            steps += 1
            if steps % 50 == 0:
                print(f"step {steps}: margin {mon.margin_s:+.2f}s "
                      f"afc={rx.afc.status if rx.afc else '-'} "
                      f"f={rx.afc.freq_hz if rx.afc else 0:.1f} Hz")
        status = gui.status()
    finally:
        wd.stop()
        gui.close()
        os.remove(smeter_path)
    print(f"served {steps} steps on {rx.device}; watchdog stalls: "
          f"{wd.stalled()}")
    return {"steps": steps, "status": status,
            "afc_status": rx.afc.status if rx.afc else None}


if __name__ == "__main__":
    a = parse(__doc__, ("port", int, 8765), ("wav", str, None))
    main(a.port, a.wav, device=a.device, tiny=a.tiny)
