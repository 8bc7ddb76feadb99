"""Run the five BASELINE.json benchmark configurations and report their
metrics (twin of examples/parity_report.py on this package).

1. fft1 wideband spectrum on a 96 kHz SSB IQ recording
2. caliq I/Q balance calibration + fft1 windowing
3. timf2 smart blanker + sellim on the back-transformed series
4. fft2/fft3 + mix1/mix2 + SSB demod to audio
5. weak-signal CW chain (Morse decode of the receiver's audio)

    python -m linrad_tpu_torch.examples.parity_report [out.md] [--device cpu]

Runs on the card unless given ``--device cpu``; ``--tiny`` cuts the
geometry (fft1 256, 1,024 samples per step) and shortens the CW message,
for tests.
"""

from __future__ import annotations

import time

import numpy as np

from linrad_tpu_torch import RxParams, derive_geometry
from linrad_tpu_torch.calibration import (apply_iq_correction,
                                          estimate_iq_balance, iq_imbalance)
from linrad_tpu_torch.examples._args import TINY, parse
from linrad_tpu_torch.io.siggen import (Tone, gaussian_noise, impulse_noise,
                                        tones_iq)
from linrad_tpu_torch.pipeline import Receiver
from linrad_tpu_torch.utils.host import to_numpy
from linrad_tpu_torch.weak.cw import decode_morse, keyed_cw


def tone_snr(z, f, fs):
    t = np.arange(len(z)) / fs
    ref = np.exp(2j * np.pi * f * t)
    amp = np.vdot(ref, z) / len(z)
    r = z - amp * ref
    return abs(amp), 10 * np.log10(
        np.vdot(z, z).real / max(np.vdot(r, r).real, 1e-30))


def _baseb(rx, iq) -> np.ndarray:
    return np.concatenate([to_numpy(o.baseb) for o in rx.run(iq)])[:, 0]


def config1(device, cut: dict) -> tuple[bool, str]:
    rx = Receiver(RxParams(first_fft_bandwidth=100.0, agc_enable=False,
                           **cut), device=device)
    g = rx.geo
    iq = tones_iq(g.rx_ad_speed, g.samples_per_step * 4,
                  [Tone(12_000.0), Tone(-20_000.0, amplitude=0.1)])
    rx.tune(12_000.0)
    out = None
    for out in rx.run(iq):
        pass
    pwr = np.sum(to_numpy(out.fft1_avg_power), axis=-1)
    k1 = int(round(12_000.0 / g.rx_ad_speed * g.fft1_size))
    k2 = int(round(-20_000.0 / g.rx_ad_speed * g.fft1_size)) % g.fft1_size
    ok = abs(int(np.argmax(pwr)) - k1) <= 1
    rel_db = 10 * np.log10(pwr[k2] / pwr[k1])
    return ok, (f"| 1 fft1 spectrum | peak at correct bin: {ok}; "
                f"-20 dB tone measured {rel_db:.1f} dB | "
                f"{'PASS' if ok else 'FAIL'} |")


def config2() -> tuple[bool, str]:
    geo = derive_geometry(RxParams(fft1_n_override=9))
    rng = np.random.default_rng(1)
    n = geo.fft1_size * 1024
    train = (rng.normal(size=n) + 1j * rng.normal(size=n)
             ).astype(np.complex64)
    c = estimate_iq_balance(iq_imbalance(train, 1.05, 0.03), geo)
    tone = tones_iq(geo.rx_ad_speed, geo.fft1_size * 4, [Tone(10_000.0)])
    bad = iq_imbalance(tone, 1.05, 0.03)
    spec = np.fft.fft(bad.reshape(4, geo.fft1_size, 1), axis=1)
    fixed = apply_iq_correction(spec, c)
    k = int(round(10_000.0 / geo.rx_ad_speed * geo.fft1_size))
    mk = (-k) % geo.fft1_size
    before = np.abs(spec[:, mk, 0]).mean() / np.abs(spec[:, k, 0]).mean()
    after = np.abs(fixed[:, mk, 0]).mean() / np.abs(fixed[:, k, 0]).mean()
    imp = 20 * np.log10(before / after)
    ok = imp > 15
    return ok, (f"| 2 caliq I/Q balance | image improved {imp:.1f} dB "
                f"(to {-20 * np.log10(after):.1f} dB rejection) | "
                f"{'PASS' if ok else 'FAIL'} |")


def config34(device, cut: dict) -> list[tuple[bool, str]]:
    base = dict(first_fft_bandwidth=100.0, mix1_bandwidth_reduction_n=4,
                second_fft_enable=True, agc_enable=False,
                clever_bln_limit=6.0, stupid_bln_limit=4.0,
                max_pulses_per_block=64)
    base.update(cut)
    rng = np.random.default_rng(0)
    snrs = {}
    fits = 0
    iq = None
    for bl in (True, False):
        rx = Receiver(RxParams(**base, blanker_enable=bl), device=device)
        g = rx.geo
        if iq is None:
            fs = g.rx_ad_speed
            n = g.samples_per_step * 6
            iq = (tones_iq(fs, n, [Tone(12_400.0)])
                  + gaussian_noise(rng, n, -11)
                  + impulse_noise(rng, n, 50.0, fs, 30.0))
        rx.tune(12_000.0)
        outs = list(rx.run(iq))
        z = np.concatenate([to_numpy(o.baseb) for o in outs])[:, 0]
        _, snrs[bl] = tone_snr(z[len(z) // 2:], 400.0,
                               g.baseband_sampling_speed)
        if bl:
            fits = sum(int(o.blanker_fitted) for o in outs)
    gain = snrs[True] - snrs[False]
    ok3 = gain > 10
    line3 = (f"| 3 sellim + smart blanker | {fits} pulses subtracted; "
             f"SNR {snrs[False]:.1f} -> {snrs[True]:.1f} dB (+{gain:.1f}) | "
             f"{'PASS' if ok3 else 'FAIL'} |")
    # config 4: demod fidelity (an amplitude-true tone through the chain)
    rx = Receiver(RxParams(**base, blanker_enable=False), device=device)
    g = rx.geo
    clean = tones_iq(g.rx_ad_speed, g.samples_per_step * 6,
                     [Tone(12_400.0)])
    rx.tune(12_000.0)
    z = _baseb(rx, clean)
    amp, snr = tone_snr(z[len(z) // 2:], 400.0, g.baseband_sampling_speed)
    ok4 = abs(amp - 1) < 0.01 and snr > 60
    line4 = (f"| 4 fft2/fft3+mix+SSB demod | amplitude {amp:.4f} (true=1), "
             f"clean-tone SNR {snr:.1f} dB | {'PASS' if ok4 else 'FAIL'} |")
    return [(ok3, line3), (ok4, line4)]


def config5(device, cut: dict, tiny: bool) -> tuple[bool, str]:
    rx = Receiver(RxParams(first_fft_bandwidth=100.0,
                           mix1_bandwidth_reduction_n=4, agc_enable=False,
                           bfo_hz=700.0, filter_low_hz=-400.0,
                           filter_high_hz=400.0, **cut), device=device)
    g = rx.geo
    msg = "TEST" if tiny else "CQ CQ DE SM5BSZ"
    cw = keyed_cw(msg, g.rx_ad_speed, 40 if tiny else 20, 12_000.0)
    pad = (-len(cw)) % g.samples_per_step
    rng = np.random.default_rng(1)
    cw = np.concatenate([cw, np.zeros(pad, np.complex64)])
    cw = cw + 0.02 * (rng.normal(size=len(cw))
                      + 1j * rng.normal(size=len(cw))).astype(np.complex64)
    rx.tune(12_000.0)
    audio = np.concatenate([to_numpy(o.audio) for o in rx.run(cw)])[:, 0]
    res = decode_morse(audio, g.baseband_sampling_speed)
    ok = res.text == msg
    return ok, (f"| 5 weak-signal CW chain | decoded {res.text!r} @ "
                f"{res.wpm:.0f} WPM (sent {msg!r}) | "
                f"{'PASS' if ok else 'FAIL'} |")


def main(out_path: str | None = None, *, device="cuda",
         tiny: bool = False) -> dict:
    """The report's lines, printed and (with ``out_path``) written as
    markdown; returns {"lines": [...], "passed": {config: bool}}."""
    t0 = time.time()
    cut = TINY if tiny else {}
    rows = [config1(device, cut), config2(), *config34(device, cut),
            config5(device, cut, tiny)]
    lines = ["# BASELINE config parity report", "",
             "| config | result | status |", "|---|---|---|",
             *(line for _ok, line in rows), "",
             f"_generated in {time.time() - t0:.0f}s on {device}"
             f"{' (tiny)' if tiny else ''}_"]
    for line in lines:
        print(line)
    if out_path:
        with open(out_path, "w") as f:
            f.write("\n".join(lines) + "\n")
    return {"lines": lines,
            "passed": {i + 1: ok for i, (ok, _line) in enumerate(rows)}}


if __name__ == "__main__":
    a = parse(__doc__, ("out_path", str, None))
    main(a.out_path, device=a.device, tiny=a.tiny)
