"""Parameters, tables and state carried between linrad_tpu and this port.

:func:`params_from_jax` turns the JAX package's ``RxParams`` (or its
``dataclasses.asdict``) into this package's ``RxParams``, field by field,
so a parity test builds one configuration and hands each package its own
type.

A table or state tree travels as a flat dict of numpy arrays keyed by
dataclass field path ("fft1.window", "mix1.phase_idx", "timf2_syn", ...).
:func:`flatten` builds such a dict from any tree of dataclasses whose
leaves convert with ``np.asarray`` (the JAX package's pytrees) or are
torch tensors; None fields are left out.  :func:`tables_from_numpy` and
:func:`state_from_numpy` build this port's ``RxTables``/``RxState`` from
the keys they need, with each array's dtype kept (the float32 real-input
``fft1.tail``, the int32 ``spur.bins``, ...); optional fields
(``spur_template``, ``fft1.iq_corr``, ``mix2.fir``, ``spur.*``,
``squelch.gate``, ``mix2_fir.carry``) are carried when present.
:func:`nbstate_from_numpy` does the same for an ``NBState``, stacked over
sub-receivers or not.  Nothing here imports jax.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from .params import Demod, InputMode, RxParams
from .pipeline.chain import NBState, RxState, RxTables


def params_from_jax(p) -> RxParams:
    """The JAX package's ``RxParams`` -> this package's ``RxParams``.

    ``p`` is the dataclass instance or its ``dataclasses.asdict`` dict;
    enums travel by value.  The two classes must have the same fields: a
    field on one side only raises (the copies have drifted apart)."""
    d = dict(p) if isinstance(p, dict) else dataclasses.asdict(p)
    names = {f.name for f in dataclasses.fields(RxParams)}
    if set(d) != names:
        raise ValueError(f"params_from_jax: fields differ: "
                         f"{sorted(set(d) ^ names)}")
    d["input_mode"] = InputMode(int(d["input_mode"]))
    d["demod"] = Demod(int(d["demod"]))
    d["notches"] = tuple(tuple(n) for n in d["notches"])
    d["filter_shape"] = tuple(tuple(n) for n in d["filter_shape"])
    return RxParams(**d)


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Dataclass tree -> {field path: numpy array}."""
    out: dict[str, np.ndarray] = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        key = prefix + f.name
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            out.update(flatten(v, key + "."))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().cpu().numpy()
        else:
            out[key] = np.asarray(v)
    return out


def _dataclass_of(hint):
    """The dataclass type named by a field annotation (X or X | None)."""
    for a in typing.get_args(hint) or (hint,):
        if dataclasses.is_dataclass(a):
            return a
    return None


def _build(cls, tree: dict, device, prefix: str):
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        key = prefix + f.name
        sub = _dataclass_of(hints[f.name])
        if sub is not None:
            present = any(k.startswith(key + ".") for k in tree)
            kw[f.name] = _build(sub, tree, device, key + ".") if present \
                else None
        elif key in tree:
            kw[f.name] = torch.from_numpy(
                np.array(tree[key], order="C")).to(device)
        else:
            kw[f.name] = None
    return cls(**kw)


def tables_from_numpy(tree: dict, device) -> RxTables:
    """Flat numpy dict (JAX ``RxTables`` flattened) -> port RxTables."""
    return _build(RxTables, tree, device, "")


def state_from_numpy(tree: dict, device) -> RxState:
    """Flat numpy dict (JAX ``RxState`` flattened) -> port RxState."""
    return _build(RxState, tree, device, "")


def nbstate_from_numpy(tree: dict, device) -> NBState:
    """Flat numpy dict (JAX ``NBState`` flattened, with or without the
    leading sub-receiver axis) -> port NBState."""
    return _build(NBState, tree, device, "")


def state_to_numpy(state: RxState | NBState) -> dict[str, np.ndarray]:
    """Port RxState or NBState -> flat numpy dict, keyed as the JAX
    state."""
    return flatten(state)
