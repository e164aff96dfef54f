"""Cutoff long-range corrections (mean-field tail).

Numpy re-derivation of the reference's homogeneous correction
(src/longRange/Homogeneous.{h,cpp}): an analytic LJ
tail integral per component pair (center-center / center-site /
site-site variants, Homogeneous.cpp:142-181) plus the reaction-field
self term of the effective molecular dipole (Homogeneous.cpp:36-64).

All of it is a function of composition only, so it is computed on the
host once (init) and folded into U_pot / virial each step
(calculateLongRange, Homogeneous.cpp:122-139):
  U_corr      =  pi*rho/(3N) * sum_LJ  +  MySelbstTerm
  Virial_corr = -pi*rho/(3N) * sum_LJv +  3*MySelbstTerm

A NoLRC null object mirrors src/longRange/NoLRC.h.
"""

from __future__ import annotations

import numpy as np


def _ticc_u(n, rc, sigma2):
    return -(rc ** (2 * n + 3)) / (sigma2 ** n * (2 * n + 3))


def _tics_u(n, rc, sigma2, tau):
    return -(
        ((rc + tau) ** (2 * n + 3) - (rc - tau) ** (2 * n + 3)) * rc
    ) / (4 * sigma2 ** n * tau * (n + 1) * (2 * n + 3)) + (
        (rc + tau) ** (2 * n + 4) - (rc - tau) ** (2 * n + 4)
    ) / (
        4 * sigma2 ** n * tau * (n + 1) * (2 * n + 3) * (2 * n + 4)
    )


def _tiss_u(n, rc, sigma2, tau1, tau2):
    tp, tm = tau1 + tau2, tau1 - tau2
    a = (
        (rc + tp) ** (2 * n + 4)
        - (rc + tm) ** (2 * n + 4)
        - (rc - tm) ** (2 * n + 4)
        + (rc - tp) ** (2 * n + 4)
    )
    b = (
        (rc + tp) ** (2 * n + 5)
        - (rc + tm) ** (2 * n + 5)
        - (rc - tm) ** (2 * n + 5)
        + (rc - tp) ** (2 * n + 5)
    )
    d = 8 * sigma2 ** n * tau1 * tau2 * (n + 1) * (2 * n + 3) * (2 * n + 4)
    return -a * rc / d + b / (d * (2 * n + 5))


def _ticc_v(n, rc, sigma2):
    return 2 * n * _ticc_u(n, rc, sigma2)


def _tics_v(n, rc, sigma2, tau):
    return -(
        ((rc + tau) ** (2 * n + 2) - (rc - tau) ** (2 * n + 2)) * rc * rc
    ) / (4 * sigma2 ** n * tau * (n + 1)) - 3 * _tics_u(n, rc, sigma2, tau)


def _tiss_v(n, rc, sigma2, tau1, tau2):
    tp, tm = tau1 + tau2, tau1 - tau2
    a = (
        (rc + tp) ** (2 * n + 3)
        - (rc + tm) ** (2 * n + 3)
        - (rc - tm) ** (2 * n + 3)
        + (rc - tp) ** (2 * n + 3)
    )
    return -a * rc * rc / (
        8 * sigma2 ** n * tau1 * tau2 * (n + 1) * (2 * n + 3)
    ) - 3 * _tiss_u(n, rc, sigma2, tau1, tau2)


class HomogeneousLRC:
    """Init computes composition-dependent sums once; per-step values are
    two scalars folded into the step's macroscopic outputs."""

    def __init__(self, table, num_molecules_per_component, volume):
        t = table
        rc = t.lj_cutoff
        K = t.K
        ncomp = np.asarray(num_molecules_per_component, float)
        assert len(ncomp) == K
        upot = 0.0
        virial = 0.0
        my_selbst = 0.0
        for i in range(K):
            ci = t.components[i]
            # effective molecular dipole from charges + point dipoles
            bal = np.zeros(3)
            for s in ci.charges:
                bal += s.q * np.asarray(s.r)
            for s in ci.dipoles:
                bal += s.abs_my * np.asarray(s.e)
            my_selbst += float(bal @ bal) * ncomp[i]
            for j in range(K):
                cj = t.components[j]
                for si, lji in enumerate(ci.ljcenters):
                    tau1 = float(np.linalg.norm(lji.r))
                    for sj, ljj in enumerate(cj.ljcenters):
                        tau2 = float(np.linalg.norm(ljj.r))
                        if tau1 + tau2 >= rc:
                            raise ValueError(
                                "LJ cutoff too small for tail correction"
                            )
                        eps24 = t.eps24[i, j, si, sj]
                        sig2 = t.sig2[i, j, si, sj]
                        shift6 = t.shift6[i, j, si, sj]
                        if shift6 != 0.0:
                            continue  # truncated-shifted: no tail
                        fac = ncomp[i] * ncomp[j] * eps24
                        if tau1 == 0.0 and tau2 == 0.0:
                            upot += fac * (_ticc_u(-6, rc, sig2) - _ticc_u(-3, rc, sig2))
                            virial += fac * (_ticc_v(-6, rc, sig2) - _ticc_v(-3, rc, sig2))
                        elif tau1 != 0.0 and tau2 != 0.0:
                            upot += fac * (
                                _tiss_u(-6, rc, sig2, tau1, tau2)
                                - _tiss_u(-3, rc, sig2, tau1, tau2)
                            )
                            virial += fac * (
                                _tiss_v(-6, rc, sig2, tau1, tau2)
                                - _tiss_v(-3, rc, sig2, tau1, tau2)
                            )
                        else:
                            tau = tau1 if tau2 == 0.0 else tau2
                            upot += fac * (
                                _tics_u(-6, rc, sig2, tau) - _tics_u(-3, rc, sig2, tau)
                            )
                            virial += fac * (
                                _tics_v(-6, rc, sig2, tau) - _tics_v(-3, rc, sig2, tau)
                            )

        n_total = float(ncomp.sum())
        rho = n_total / float(volume)
        fac = np.pi * rho / (3.0 * max(n_total, 1.0))
        upot_lj = fac * upot
        virial_lj = -fac * virial
        rc_el = t.cutoff
        eps_rf_invrc3 = (
            2.0 * (t.eps_rf - 1.0) / ((rc_el ** 3) * (2.0 * t.eps_rf + 1.0))
        )
        my_term = -0.5 * eps_rf_invrc3 * my_selbst
        self.upot_corr = float(upot_lj + my_term)
        self.virial_corr = float(virial_lj + 3.0 * my_term)


class NoLRC:
    """Null correction (src/longRange/NoLRC.h)."""

    upot_corr = 0.0
    virial_corr = 0.0

    def __init__(self, *a, **k):
        pass
