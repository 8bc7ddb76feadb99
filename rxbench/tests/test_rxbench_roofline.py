"""The roofline arithmetic gives the byte counts the port's smoke test
reported on the card (PERF.md section 6)."""

import torch

from rxbench.roofline import blanker_fits, fused_fft1, sellim_taper


def test_fused_fft1_bytes():
    assert fused_fft1.bytes_moved(64, 2048, 1) == 2_129_920
    assert fused_fft1.bytes_moved(64, 4096, 2) == 8_503_296
    assert fused_fft1.bytes_moved(64, 2048, 8) == 16_982_016


def test_fits_bytes_at_the_flagship():
    from rxbench.reference.geometry import derive_geometry
    from rxbench.reference.receiver import make_params
    from rxbench import core
    cfg = core.load_json(core.BENCH_DIR / "configs" / "ssb-nb-96k.json")
    geo = derive_geometry(make_params(cfg["params"]))
    sh = blanker_fits.shape(geo, 256, 1)
    assert (sh["total"], sh["c"], sh["pul"]) == (65_792, 1, 64)
    nbytes, _ops = blanker_fits.bytes_ops(sh["r"], sh["total"], sh["c"],
                                          sh["nblk"], sh["pul"], sh["s"], 31)
    assert nbytes == 1_856_524
    eight = blanker_fits.shape(geo, 256, 8)
    assert blanker_fits.bytes_ops(*(eight[k] for k in (
        "r", "total", "c", "nblk", "pul", "s")), 310)[0] == 14_880_352


def test_taper_bytes_and_operations():
    assert sellim_taper.bytes_moved(1, 2048) == 24_576
    assert sellim_taper.bytes_moved(8, 2048) == 196_608
    lim = torch.zeros(64)
    budget = torch.zeros(64)
    assert sellim_taper.operations(lim, budget) == 12 * 64
    lim[10], budget[10] = 0.5, 3.0
    # one source lighting 3 bins each way: one chain of 3 powf
    assert sellim_taper.operations(lim, budget) == 12 * 64 + 20 * 3
