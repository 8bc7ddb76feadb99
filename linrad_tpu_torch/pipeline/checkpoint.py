"""Receiver state checkpoint/resume (port of
linrad_tpu/pipeline/checkpoint.py).

The reference checkpoints configuration only (par_* files, calibration;
signal state is never saved: "resume" means replaying the raw
recording).  Here the full pipeline state is a tree of tensors, so saving
and restoring mid-stream is exact: processing can stop after block N and
resume bit-identically, which is useful for long unattended EME captures
and for elastic batch processing.

The file is an ``.npz``: every state leaf under its field path
("fft1.tail", "agc.level", ...: the flat dict of ``convert.flatten``), so
a checkpoint survives an optional field added later, and a JSON
``__meta__`` with the parameters, the tuning, the step count and the
AFC's fit history.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import convert
from ..params import RxParams

META = "__meta__"


def save_receiver(path: str, rx) -> None:
    """Save params + full pipeline state (+AFC/controller state)."""
    data = convert.flatten(rx.state)
    meta = {
        "params": rx.params.to_json(),
        "tune_bin": rx._tune_bin.cpu().numpy().tolist(),
        "tune_frac": rx._tune_frac.cpu().numpy().tolist(),
        "tune_slope": (None if rx._tune_slope is None
                       else rx._tune_slope.cpu().numpy().tolist()),
        "steps_done": rx._steps_done,
    }
    if rx.afc is not None:
        meta["afc"] = {
            "status": rx.afc.status, "freq_hz": rx.afc.freq_hz,
            "times": list(rx.afc._times), "freqs": list(rx.afc._freqs),
            "weights": list(rx.afc._weights),
        }
    np.savez(path, **{META: json.dumps(meta)}, **data)


def load_receiver(path: str, device="cuda", **receiver_kw):
    """Rebuild a Receiver on ``device`` resuming exactly where it
    stopped.  ``receiver_kw``: further keywords of ``Receiver``
    (``graphed``, ``recorded``); a graphed receiver takes the saved state
    into its graphs' buffers."""
    from .receiver import Receiver

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z[META]))
        tree = {k: z[k] for k in z.files if k != META}
    rx = Receiver(RxParams.from_json(meta["params"]), device=device,
                  **receiver_kw)
    rx.state = convert.state_from_numpy(tree, rx.device)
    rx._tune_bin = torch.tensor(meta["tune_bin"], dtype=torch.int64,
                                device=rx.device)
    rx._tune_frac = torch.tensor(meta.get("tune_frac", 0.0),
                                 dtype=torch.float32, device=rx.device)
    slope = meta.get("tune_slope")
    rx._tune_slope = (None if slope is None else torch.tensor(
        slope, dtype=torch.float32, device=rx.device))
    rx._steps_done = meta["steps_done"]
    if rx.afc is not None and "afc" in meta:
        a = meta["afc"]
        rx.afc.status = a["status"]
        rx.afc.freq_hz = a["freq_hz"]
        rx.afc._times = list(a["times"])
        rx.afc._freqs = list(a["freqs"])
        rx.afc._weights = list(a["weights"])
    return rx
