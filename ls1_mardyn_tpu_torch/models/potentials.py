"""Site-site pair potentials (the counterpart of
ls1_mardyn_tpu/models/potentials.py).  Slice 1 needs LJ-12-6 only; the
multipole terms come with the multi-site slice."""

from __future__ import annotations

import torch

_EPS = 1e-30


def lj(dr: torch.Tensor, dr2: torch.Tensor, eps24, sig2):
    """LJ-12-6 between two centers; PotForceLJ (potforce.h:18-31).

    dr [..., 3] is site_i - site_j, dr2 [...] its squared length.
    Returns (f [..., 3] on site i, u6 [...]) where u6 = 6*U (the
    reference accumulates Upot6LJ and divides by 6 at the end); the
    caller adds shift6 and masks pairs beyond the cutoff.
    """
    invdr2 = 1.0 / torch.clamp(dr2, min=_EPS)
    lj6 = sig2 * invdr2
    lj6 = lj6 * lj6 * lj6
    lj12 = lj6 * lj6
    lj12m6 = lj12 - lj6
    u6 = eps24 * lj12m6
    fac = eps24 * (lj12 + lj12m6) * invdr2
    return fac[..., None] * dr, u6
