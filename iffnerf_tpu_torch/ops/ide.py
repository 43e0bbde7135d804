"""Integrated Directional Encoding (Ref-NeRF; reference: models/ref_utils.py:23-112).

The coefficient tables stay numpy on the host (static per ``deg_view``).
The harmonics are evaluated in real float32 arithmetic: ``(x + iy) ** m``
by repeated complex multiplication, and each harmonic's z-dependence by the
stable three-term associated-Legendre recurrence, as the JAX package does
(the reference's raw monomial expansion cancels catastrophically in
float32 for l = 8).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _ml_array(deg_view: int) -> np.ndarray:
    """[2, M] int32: rows (m, l), columns l = 2^i for i < deg_view and
    m = 0..l."""
    ml = [(m, 2 ** i) for i in range(deg_view) for m in range(2 ** i + 1)]
    return np.array(ml, dtype=np.int32).T


def _generalized_binomial_coeff(a: float, k: int) -> float:
    return float(np.prod(a - np.arange(k))) / math.factorial(k)


def _assoc_legendre_coeff(l: int, m: int, k: int) -> float:
    return ((-1) ** m * 2 ** l * math.factorial(l) / math.factorial(k)
            / math.factorial(l - k - m)
            * _generalized_binomial_coeff(0.5 * (l + k + m - 1.0), l))


def _sph_harm_coeff(l: int, m: int, k: int) -> float:
    return (math.sqrt((2.0 * l + 1.0) * math.factorial(l - m)
                      / (4.0 * math.pi * math.factorial(l + m)))
            * _assoc_legendre_coeff(l, m, k))


@lru_cache(maxsize=None)
def integrated_dir_enc_coeffs(deg_view: int):
    """The reference's static tables (ref_utils.py:23-60): (ml_array [2, M]
    int32, mat [l_max + 1, M] float32), mat[k, i] the coefficient of z^k in
    harmonic i's monomial expansion, computed in float64. The encoding
    itself takes the recurrence above and does not read ``mat``."""
    ml_array = _ml_array(deg_view)
    l_max = 2 ** (deg_view - 1)
    mat = np.zeros((l_max + 1, ml_array.shape[1]), dtype=np.float64)
    for i, (m, l) in enumerate(ml_array.T):
        for k in range(l - m + 1):
            mat[k, i] = _sph_harm_coeff(int(l), int(m), k)
    return ml_array, mat.astype(np.float32)


def ide_output_dim(deg_view: int) -> int:
    return sum((2 ** i) + 1 for i in range(deg_view)) * 2


def integrated_dir_enc(xyz: torch.Tensor, kappa_inv: torch.Tensor,
                       deg_view: int = 4) -> torch.Tensor:
    """IDE of unit directions ``xyz`` [..., 3] under a vMF roughness
    ``kappa_inv`` [..., 1] -> [..., 2*M], (real, imag) interleaved per
    harmonic (torch ``view_as_real(...).reshape(..., -1)`` order).

    With A_l^m(z) := P_l^m(z) / (1 - z^2)^{m/2} (Condon-Shortley phase):
        A_m^m     = (-1)^m (2m-1)!!
        A_{m+1}^m = z (2m+1) A_m^m
        A_l^m     = ((2l-1) z A_{l-1}^m - (l+m-1) A_{l-2}^m) / (l - m)
    and the harmonic is N_l^m * A_l^m(z) * (x+iy)^m."""
    ml = _ml_array(deg_view)
    l_max = int(2 ** (deg_view - 1))

    xs, ys, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]

    cm_re = [torch.ones_like(z)]
    cm_im = [torch.zeros_like(z)]
    for _ in range(l_max):
        pr, pi = cm_re[-1], cm_im[-1]
        cm_re.append(pr * xs - pi * ys)
        cm_im.append(pr * ys + pi * xs)

    a: dict = {}
    dfact = 1.0  # (2m-1)!!
    for m in range(l_max + 1):
        sign = -1.0 if (m % 2) else 1.0
        a[(m, m)] = torch.full_like(z, sign * dfact)
        dfact *= 2 * m + 1
        if m + 1 <= l_max:
            a[(m + 1, m)] = z * (2 * m + 1) * a[(m, m)]
        for l in range(m + 2, l_max + 1):
            a[(l, m)] = ((2 * l - 1) * z * a[(l - 1, m)]
                         - (l + m - 1) * a[(l - 2, m)]) / (l - m)

    res, ims, sigmas = [], [], []
    for m, l in ml.T:
        m, l = int(m), int(l)
        n_lm = math.sqrt(
            (2.0 * l + 1.0)
            * math.factorial(l - m)
            / (4.0 * math.pi * math.factorial(l + m))
        )
        base = n_lm * a[(l, m)]
        res.append(base * cm_re[m])
        ims.append(base * cm_im[m])
        sigmas.append(0.5 * l * (l + 1.0))

    sph_re = torch.stack(res, dim=-1)
    sph_im = torch.stack(ims, dim=-1)
    atten = torch.exp(-torch.tensor(sigmas, dtype=xyz.dtype,
                                    device=xyz.device) * kappa_inv)
    out = torch.stack([sph_re * atten, sph_im * atten], dim=-1)
    return out.reshape(out.shape[:-2] + (-1,))
