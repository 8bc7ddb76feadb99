"""Transmit chain (port of linrad_tpu/tx/): CW keying, SSB speech processing, modulators, radar
pulse trains, streamed file->DAC output with delay accounting — the
reference's TX layer (tx.c, txssb.c, SURVEY.md §2.8)."""

from .keying import ascii_keying, cw_envelope, pilot_tone, radar_pulse_train
from .modulate import am_modulate, fm_modulate, ssb_modulate
from .ssbproc import SSBProcessor, SSBProcParams
from .stream import (SsbTxStreamer, StageBuffer, TxDelayModel,
                     TxFormatError, TxStreamer, WavTxSource)

__all__ = [
    "cw_envelope", "ascii_keying", "radar_pulse_train", "pilot_tone",
    "ssb_modulate", "am_modulate", "fm_modulate",
    "SSBProcessor", "SSBProcParams",
    "TxStreamer", "SsbTxStreamer", "WavTxSource", "TxDelayModel",
    "StageBuffer", "TxFormatError",
]
