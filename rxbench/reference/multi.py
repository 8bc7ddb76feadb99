"""The multi-receiver's host loop in plain form: the port's
``MultiReceiver.tune_subch`` and ``process_block`` without graphs, over
this package's frozen ``make_multi_rx_step``: one wideband front end
feeding K sub-receivers, the narrowband tail run once on tensors with a
leading K axis (Linrad's 24 mix1 slots, globdef.h:315, 1282-1294).

Plain torch: it imports nothing of ``linrad_tpu_torch`` and nothing of
JAX, and keeps TF32 off."""

from __future__ import annotations

import torch

from .geometry import derive_geometry
from .ops.blanker import BlankerTables
from .params import RxParams
from .pipeline.chain import NBState, RxState, RxTables, make_multi_rx_step


class PlainMultiReceiver:
    """K sub-receivers of ``params`` over one front end on ``device``: its
    own tables, wideband state (``state``), stacked narrowband states
    (``nbs``, K first) and integer fftx tuning (``tune_bins``)."""

    def __init__(self, params: RxParams, n_subch: int, device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.params = params
        self.n_subch = n_subch
        self.geo = derive_geometry(params)
        self.tables = RxTables.create(self.geo, params, self.device)
        fir = self.tables.mix2.fir
        fir_len = int(fir.shape[0]) if fir is not None else 0
        self.state = RxState.create(self.geo, self.device,
                                    spur=params.spur_enable, fir_len=fir_len)
        self.nbs = NBState.create_stacked(self.geo, n_subch, self.device,
                                          pol=params.pol_adapt_enable,
                                          fir_len=fir_len)
        pulsewidth = (BlankerTables.create(self.geo, "cpu")[1]
                      if self.geo.second_fft_enable else 2)
        self.step = make_multi_rx_step(self.geo, params,
                                       blanker_pulsewidth=pulsewidth)
        self.tune_bins = torch.zeros(n_subch, dtype=torch.int64,
                                     device=self.device)

    def tune_subch(self, k: int, freq_hz: float) -> None:
        """Sub-receiver k to the fftx bin nearest ``freq_hz``."""
        n = self.geo.fftx_size
        fs = self.geo.timf1_sampling_speed
        self.tune_bins[k] = int(round(freq_hz / fs * n)) % n

    def process_block(self, block: torch.Tensor):
        """One step on a (samples_per_step, C) complex64 block; the
        outputs' audio, baseb and agc_gain carry the K axis in front."""
        (self.state, self.nbs), out = self.step(
            self.tables, self.state, self.nbs, block, self.tune_bins)
        return out
