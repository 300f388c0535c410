"""Fourier phase-matrix kernels as GSF-basis matmuls.

Re-design of the kernel part of reference ``SOS_NOYAUX``
(``src/SOS_OS.F:2114-2155``): the reference fills six ``(2N+1)^2`` matrices
per Fourier order with an explicit ``O(OS_NB * NBMU^2)`` loop nest; here each
matrix is a matmul ``F^T diag(c) G`` over the precomputed GSF basis, batched
over all Fourier orders at once — three dense contractions.

Kernel definitions (reference ``src/SOS_OS.F:2134-2153``)::

    BP (a,b) = sum_L beta_L  PSL(L,a) PSL(L,b)          # P11
    GR (a,b) = sum_L gamma_L PSL(L,a) RSL(L,b)          # P12 block
    GT (a,b) = sum_L gamma_L PSL(L,a) TSL(L,b)          # P13 block
    ARR(a,b) = sum_L zeta_L TSL TSL + alpha_L RSL RSL   # P22
    ATT(a,b) = sum_L alpha_L TSL TSL + zeta_L RSL RSL   # P33
    ART(a,b) = sum_L alpha_L RSL(L,b) TSL(L,a) + zeta_L RSL(L,a) TSL(L,b)

The full 3x3-block scattering operator P_st(k, j) (output Stokes s at
direction k, input Stokes t from direction j) used by the source-function
contraction (``SOS_FSOURCE_ORDREIG`` ``src/SOS_OS.F:2663``, verified term by
term against ``:2894-2905``) is::

    [  BP(k,j)    GR(k,j)   -GT(k,j) ]
    [  GR(j,k)   ARR(k,j)  -ART(j,k) ]
    [ -GT(j,k)  -ART(k,j)   ATT(k,j) ]

The molecular (Rayleigh + depolarization) kernel uses the same formulas with
coefficients beta = [beta0(IS==0), 0, beta2], gamma = [0,0,gamma2],
alpha = [0,0,alpha2], zeta = 0 (``src/SOS_OS.F:678-699, 2859-2876``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def molecular_coeffs(ron):
    """(beta0, beta2, gamma2, alpha2) from the depolarization factor.

    Reference ``src/SOS_OS.F:678-684``.
    """
    aaa = ron / (2.0 - ron)
    aaa = (1.0 - aaa) / (1.0 + 2.0 * aaa)
    beta0 = 1.0
    beta2 = 0.5 * aaa
    gamma2 = -aaa * np.sqrt(1.5)
    alpha2 = 3.0 * aaa
    return beta0, beta2, gamma2, alpha2


def _pair(f, coef, g):
    """sum_L coef[...,L] f[s,L,a] g[s,L,b] -> (S, D, D), batched over IS."""
    coef = jnp.asarray(coef)
    if coef.ndim == 1:
        coef = coef[None, :]
    # precision: a default-precision f32 einsum may multiply in reduced
    # precision (TF32 on a GPU); the OS_NB ~ 80-term Legendre contraction
    # would lose ~2-3 digits in the kernels that seed every scattering
    # order (precision.py gate)
    return jnp.einsum("sla,sl,slb->sab", f, coef, g,
                      preferred_element_type=f.dtype,
                      precision=jax.lax.Precision.HIGHEST)


def block_kernel(psl, rsl, tsl, alpha, beta, gamma, zeta):
    """Full 3x3-block phase operator P[s, so, si, a, b].

    ``psl/rsl/tsl``: (S, L+1, D) GSF basis; coefficient vectors (L+1,) or
    per-order (S, L+1).  Returns (S, 3, 3, D, D).
    """
    bp = _pair(psl, beta, psl)
    gr = _pair(psl, gamma, rsl)
    gt = _pair(psl, gamma, tsl)
    arr = _pair(tsl, zeta, tsl) + _pair(rsl, alpha, rsl)
    att = _pair(tsl, alpha, tsl) + _pair(rsl, zeta, rsl)
    art = _pair(tsl, alpha, rsl) + jnp.swapaxes(_pair(tsl, zeta, rsl), -1, -2)

    grt = jnp.swapaxes(gr, -1, -2)
    gtt = jnp.swapaxes(gt, -1, -2)
    artt = jnp.swapaxes(art, -1, -2)
    row0 = jnp.stack([bp, gr, -gt], axis=1)
    row1 = jnp.stack([grt, arr, -artt], axis=1)
    row2 = jnp.stack([-gtt, -art, att], axis=1)
    return jnp.stack([row0, row1, row2], axis=1)


def aerosol_kernel(psl, rsl, tsl, alpha, beta, gamma, zeta,
                   ipolar: bool = True):
    """Aerosol phase operator for every Fourier order (S, 3, 3, D, D).

    With ``ipolar`` False the polarized expansion coefficients are cut
    like the reference's atmospheric polarization cutoff
    (``src/SOS_OS.F:687-699`` zeroes ALPHA/GAMMA/ZETA too, not only the
    molecular gamma2/alpha2).
    """
    if not ipolar:
        alpha = np.zeros_like(np.asarray(alpha))
        gamma = np.zeros_like(np.asarray(gamma))
        zeta = np.zeros_like(np.asarray(zeta))
    return block_kernel(psl, rsl, tsl, alpha, beta, gamma, zeta)


def molecular_kernel(psl, rsl, tsl, ron, ipolar: bool = True):
    """Molecular phase operator (S, 3, 3, D, D); zero for IS > 2.

    ``beta0`` only contributes at IS = 0 (``src/SOS_OS.F:886-890``), and the
    whole molecular matrix vanishes for IS > 2 (``src/SOS_OS.F:2536-2544``).
    With ``ipolar`` False the polarized coefficients are cut
    (``src/SOS_OS.F:689-699``).
    """
    n_s, n_l, _ = psl.shape
    beta0, beta2, gamma2, alpha2 = molecular_coeffs(ron)
    if not ipolar:
        gamma2 = 0.0
        alpha2 = 0.0
    dt = psl.dtype

    def vec(l_index, value, first_order_only=False):
        c = np.zeros((n_s, n_l))
        if l_index < n_l:
            c[:, l_index] = value
            if first_order_only:
                c[1:, l_index] = 0.0
        c[3:, :] = 0.0     # molecular matrix null for IS > 2
        return jnp.asarray(c, dtype=dt)

    beta = vec(0, beta0, first_order_only=True) + vec(2, beta2)
    gamma = vec(2, gamma2)
    alpha = vec(2, alpha2)
    zeta = jnp.zeros((n_s, n_l), dtype=dt)
    return block_kernel(psl, rsl, tsl, alpha, beta, gamma, zeta)
