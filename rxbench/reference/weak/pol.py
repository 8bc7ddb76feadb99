"""Adaptive dual-channel polarization (port of linrad_tpu/weak/pol.py,
reference pol_graph.c).

From a 2-channel (X/Y antenna) baseband, the smoothed 2x2 coherency
matrix gives the signal's polarization state; projecting onto its
dominant eigenvector is the adaptive combination that maximises S/N for
a signal whose polarization Faraday rotation and libration turn.  The
eigenvector is the JAX version's closed form, term for term (not
``torch.linalg.eigh``, whose phase and sign convention differ and would
rotate the combined baseband)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class PolState:
    """Smoothed coherency matrix (2x2 Hermitian)."""

    coherency: torch.Tensor  # (..., 2, 2) complex64

    @classmethod
    def create(cls, device) -> "PolState":
        return cls(coherency=torch.eye(2, dtype=torch.complex64,
                                       device=device))


@dataclass
class PolInfo:
    """Polarization ellipse readout (the POL graph numbers)."""

    tilt_deg: float        # polarization plane angle
    axial_ratio_db: float  # circularity: 0 dB = circular, inf = linear
    coherence: float       # fraction of power in the dominant state


def update_polarization(state: PolState, baseb2: torch.Tensor,
                        alpha: float = 0.1
                        ) -> tuple[PolState, torch.Tensor, torch.Tensor]:
    """One block update: estimate, then project.

    baseb2: (..., S, 2) complex64, the state stacked on the same leading
    axes.  Returns (state, combined (..., S) complex64, weights (..., 2)
    complex64)."""
    r = torch.einsum("...si,...sj->...ij", baseb2,
                     baseb2.conj()) / baseb2.shape[-2]
    coh = (1.0 - alpha) * state.coherency + alpha * r
    # closed-form dominant eigenvector of a 2x2 Hermitian matrix
    a = coh[..., 0, 0].real
    d = coh[..., 1, 1].real
    b = coh[..., 0, 1]
    tr = a + d
    det = a * d - b.abs() ** 2
    lam = 0.5 * (tr + torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))
    # eigenvector for lam: (A - lam I) v = 0 -> v ~ [b, lam - a]
    v_gen = torch.stack([b, (lam - a).to(coh.dtype)], dim=-1)
    # [1, 0] made on the device (no host-to-device copy inside a step)
    x_axis = (torch.arange(2, device=coh.device) == 0).to(coh.dtype)
    v_axis = torch.where((a >= d)[..., None], x_axis, x_axis.flip(0))
    v = torch.where((b.abs() > 1e-12 * torch.maximum(a, d))[..., None],
                    v_gen, v_axis)
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                        min=1e-20)
    return PolState(coherency=coh), project(baseb2, v), v


def project(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x2 (..., S, 2) onto the weights w (..., 2): sum_c x2[..., c] *
    conj(w[c]), (..., S)."""
    return (x2 * w.conj()[..., None, :]).sum(-1)


def pol_info(state: PolState) -> PolInfo:
    """Ellipse parameters from the coherency matrix (host side)."""
    coh = state.coherency.detach().cpu().numpy()
    w, vecs = np.linalg.eigh(coh)
    v = vecs[:, -1]  # dominant
    ex, ey = v[0], v[1]
    tilt = 0.5 * np.degrees(np.arctan2(
        2 * np.real(ex * np.conj(ey)),
        np.abs(ex) ** 2 - np.abs(ey) ** 2))
    s3 = 2 * np.imag(ex * np.conj(ey))
    s0 = np.abs(ex) ** 2 + np.abs(ey) ** 2
    chi = 0.5 * np.arcsin(np.clip(s3 / max(s0, 1e-20), -1, 1))
    t = abs(np.tan(chi))
    ar_db = 20 * np.log10(1.0 / max(t, 1e-6)) if t < 1 else 0.0
    coherence = float(w[-1] / max(w.sum(), 1e-20))
    return PolInfo(tilt_deg=float(tilt), axial_ratio_db=float(ar_db),
                   coherence=coherence)
