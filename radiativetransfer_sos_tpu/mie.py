"""Mie scattering kernel, vectorized over the size-parameter sweep.

Re-design of reference ``SOS_MIE`` / ``SOS_FPHASE_MIE``
(``src/SOS_MIE.F:205,801``).  The reference loops alpha values sequentially
(adaptive step 1e-4 -> 1.0, ``src/SOS_MIE.F:404-409``), running four scalar
recurrences per alpha and an O(N2 * n_angles) series sum.  Here:

* the alpha sweep is a batch axis (``lax.scan`` over the series order n,
  ``vmap`` over alpha);
* the angular functions pi_n(mu), tau_n(mu) are alpha-independent and
  precomputed once as an (N, n_angles) table;
* the amplitude sums S1/S2 become two (n_alpha x N) @ (N x n_angles)
  matmuls — the dense-matmul path that replaces the reference's hot loop
  (``src/SOS_MIE.F:884-901``).

Numerical scheme (faithful to the reference):

* ``Gn(alpha)`` (complex log-derivative of the Riccati-Bessel zeta) by upward
  recurrence; ``Cn(alpha)`` (chi) upward with a divergence cut at 1e304 that
  truncates the effective series order per alpha (``src/SOS_MIE.F:447-468``)
  — reproduced here with a frozen-carry mask;
* ``Dn(alpha)``, ``Dn(m*alpha)`` by downward recurrence from N1 = 2 alpha+20;
* ``Sn(alpha)`` (psi) downward with overflow renormalization, normalized by
  sin(alpha) (``src/SOS_MIE.F:497-528``) — here the renormalization constant
  is folded in exactly once since only ratios Sn/S0 matter.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as cte

_OVER = 1.0e304


class MieResult(NamedTuple):
    alpha: jnp.ndarray    # (A,)
    qext: jnp.ndarray     # (A,)
    qsca: jnp.ndarray     # (A,)
    g: jnp.ndarray        # (A,) asymmetry factor
    imie: jnp.ndarray     # (A, D) phase function I(mu)
    qmie: jnp.ndarray     # (A, D) polarized phase function Q(mu)
    umie: jnp.ndarray     # (A, D) polarized phase function U(mu)


def alpha_sweep(alpha_min: float, alpha_max: float) -> np.ndarray:
    """The reference's adaptive alpha grid (``src/SOS_MIE.F:404-409``)."""
    vals = []
    a = alpha_min
    while a <= alpha_max:
        vals.append(a)
        if a > 100.0:
            pas = 1.0
        elif a > 30.0:
            pas = 0.10
        elif a > 10.0:
            pas = 0.05
        elif a > 1.0:
            pas = 0.01
        elif a > 0.1:
            pas = 0.001
        else:
            pas = 0.0001
        a = a + pas
    return np.asarray(vals)


def pi_tau_tables(mu: np.ndarray, n_max: int) -> tuple[np.ndarray, np.ndarray]:
    """Angular functions pi_n(x), tau_n(x) for x = -mu, n = 1..n_max.

    Recurrence of ``SOS_FPHASE_MIE`` (``src/SOS_MIE.F:879-899``).  Host
    precompute (alpha-independent), float64.  Returns (n_max, D) arrays.
    """
    x = -np.asarray(mu)
    d = x.shape[0]
    pi_t = np.zeros((n_max + 1, d))
    tau_t = np.zeros((n_max + 1, d))
    pim = np.zeros(d)
    piv = np.ones(d)
    tau = x.copy()
    for n in range(1, n_max + 1):
        pi_t[n] = piv
        tau_t[n] = tau
        pip = ((2.0 * n + 1.0) * x * piv - (n + 1.0) * pim) / n
        pim = piv
        piv = pip
        tau = (n + 1.0) * x * piv - (n + 2.0) * pim
    return pi_t[1:], tau_t[1:]


def _gn_cn(alpha, n_max):
    """Upward recurrences for Gn (complex) and Cn with the divergence cut.

    Returns (rgn, ign, cn, n2_eff) with arrays over n = 1..n_max; entries
    beyond the per-alpha effective order are frozen/masked.
    Reference ``src/SOS_MIE.F:434-468``.
    """
    def step(carry, n):
        rg, ig_, c_prev, c_prev2, stopped, n2 = carry
        z = n / alpha
        w = (z - rg) ** 2 + ig_ * ig_
        rg_n = (z - rg) / w - z
        ig_n = ig_ / w
        c_n = (2.0 * n - 1.0) * c_prev / alpha - c_prev2
        diverged = c_n >= _OVER
        now_stop = (~stopped) & diverged
        n2_new = jnp.where(now_stop, n, n2)
        stop_new = stopped | diverged
        # freeze values once stopped (the reference exits the loop)
        rg_out = jnp.where(stopped, rg, rg_n)
        ig_out = jnp.where(stopped, ig_, ig_n)
        c_out = jnp.where(stopped, c_prev, c_n)
        return ((rg_out, ig_out, c_out, jnp.where(stopped, c_prev2, c_prev),
                 stop_new, n2_new),
                (rg_out, ig_out, c_out))

    init = (jnp.zeros_like(alpha), -jnp.ones_like(alpha),
            jnp.cos(alpha), -jnp.sin(alpha),
            jnp.zeros_like(alpha, dtype=bool),
            jnp.full_like(alpha, n_max, dtype=jnp.int64))
    (rg, ig_, c, _, stopped, n2), (rgn, ign, cn) = lax_scan_over_n(
        step, init, n_max)
    return rgn, ign, cn, n2


def lax_scan_over_n(step, init, n_max):
    ns = jnp.arange(1, n_max + 1)
    return jax.lax.scan(step, init, ns)


def _dn_sn(alpha, rn, in_, n_max):
    """Downward recurrences for Dn(alpha), Dn(m alpha), Sn(alpha).

    Reference ``src/SOS_MIE.F:478-528``.  The Sn overflow renormalization
    divides all computed terms by the overflowing value — since every use of
    Sn is scaled by ``Q = S0/sin(alpha)`` afterwards, tracking the running
    scale is exact; we renormalize the carry and final values identically.
    Returns (rdna, rdnb, idnb, sna) over n = 1..n_max (index 0 of the
    reference arrays is only used for the S0 normalization).
    """
    rbeta = rn * alpha
    ibeta = in_ * alpha
    x1 = rbeta * rbeta + ibeta * ibeta
    x2 = rbeta / x1
    x3 = ibeta / x1

    def step(carry, i):
        rdna_p, rdnb_p, idnb_p, sn_p, sn_pp = carry     # values at i+1, i+2
        z = rdnb_p + (i + 1.0) * x2
        w = idnb_p - (i + 1.0) * x3
        x4 = z * z + w * w
        rdnb_i = (i + 1.0) * x2 - z / x4
        idnb_i = -(i + 1.0) * x3 + w / x4
        zz = (i + 1.0) / alpha
        rdna_i = zz - 1.0 / (rdna_p + zz)
        sn_im1 = (2.0 * i + 1.0) * sn_p / alpha - sn_pp
        # overflow renormalization: scale the whole running sequence
        scale = jnp.where(sn_im1 > _OVER, sn_im1, 1.0)
        sn_im1n = sn_im1 / scale
        sn_pn = sn_p / scale
        return ((rdna_i, rdnb_i, idnb_i, sn_im1n, sn_pn),
                (rdna_i, rdnb_i, idnb_i, sn_pn, scale))

    init = (jnp.zeros_like(alpha),) * 3 + (jnp.ones_like(alpha),
                                           jnp.zeros_like(alpha))
    ns = jnp.arange(n_max - 1, -1, -1, dtype=alpha.dtype)
    carry, (rdna_seq, rdnb_seq, idnb_seq, sn_seq, scales) = jax.lax.scan(
        step, init, ns)
    # sequences are produced for i = n_max-1 .. 0; reorder ascending in i.
    rdna = jnp.flip(rdna_seq, 0)        # D_i for i = 0..n_max-1
    rdnb = jnp.flip(rdnb_seq, 0)
    idnb = jnp.flip(idnb_seq, 0)
    sna = jnp.flip(sn_seq, 0)           # S_i emitted at the step for index i
    # The step for index i emits S_i already divided by that step's scale;
    # the scales of the steps executed afterwards (indices i-1 .. 0) must
    # divide it too, exactly like the reference's in-place renormalization
    # of all previously stored terms (src/SOS_MIE.F:512-521).
    log_sc = jnp.log(jnp.flip(scales, 0))
    prefix_excl = jnp.cumsum(log_sc, axis=0) - log_sc
    sna = sna / jnp.exp(prefix_excl)
    q = sna[0] / jnp.sin(alpha)
    sna = sna / q
    # arrays indexed by n = 1..n_max correspond to positions 1..n_max-1 plus
    # the boundary S_{n_max} = 0; shift so index k holds order n = k+1.
    rdna_n = jnp.concatenate([rdna[1:], jnp.zeros_like(rdna[:1])], axis=0)
    rdnb_n = jnp.concatenate([rdnb[1:], jnp.zeros_like(rdnb[:1])], axis=0)
    idnb_n = jnp.concatenate([idnb[1:], jnp.zeros_like(idnb[:1])], axis=0)
    sna_n = jnp.concatenate([sna[1:], jnp.zeros_like(sna[:1])], axis=0)
    return rdna_n, rdnb_n, idnb_n, sna_n


def _an_bn(alpha, rn, in_, n_max):
    """Mie coefficients A_n, B_n (as the reference's RA/IA/RB/IB combination,
    ``src/SOS_MIE.F:535-585``), masked beyond the per-alpha effective order.

    Returns (ra, ia, rb, ib, n2) with shape (n_max,) per alpha scalar.
    """
    rgna, igna, cna, n2 = _gn_cn(alpha, n_max)
    rdna, rdnb, idnb, sna = _dn_sn(alpha, rn, in_, n_max)

    ns = jnp.arange(1, n_max + 1, dtype=alpha.dtype)
    x1, x2 = sna, cna
    x3, x4, x5 = rdnb, idnb, rdna
    x6, x7 = rgna, igna
    y1 = x3 - rn * x5
    y2 = x4 - in_ * x5
    y3 = x3 - rn * x6 + in_ * x7
    y4 = x4 - rn * x7 - in_ * x6
    y5 = rn * x3 - in_ * x4 - x5
    y6 = in_ * x3 + rn * x4
    y7 = rn * x3 - in_ * x4 - x6
    y8 = in_ * x3 + rn * x4 - x7
    z4 = y2 * y3 - y1 * y4
    z3 = y1 * y3 + y2 * y4
    z5 = x1 * x1 + x2 * x2
    z6 = y3 * y3 + y4 * y4
    z7 = y5 * y7 + y6 * y8
    z8 = y6 * y7 - y5 * y8
    z9 = y7 * y7 + y8 * y8
    q = (2.0 * ns + 1.0) / ns / (ns + 1.0) * jnp.where(ns % 2 == 1, 1.0, -1.0)

    big = x2 > 1.0e300
    yy1 = jnp.where(big, 0.0, x1 * (x1 * z3 + x2 * z4) / z5 / z6)
    yy2 = jnp.where(big, 0.0, x1 * (x1 * z4 - x2 * z3) / z5 / z6)
    yy3 = jnp.where(big, 0.0, x1 * (x1 * z7 + x2 * z8) / z5 / z9)
    yy4 = jnp.where(big, 0.0, x1 * (x1 * z8 - x2 * z7) / z5 / z9)

    ra = yy2 * q
    ib = yy3 * q
    rb = -yy4 * q
    ia = -yy1 * q

    mask = (jnp.arange(1, n_max + 1) <= n2).astype(alpha.dtype)
    return ra * mask, ia * mask, rb * mask, ib * mask, n2


def _efficiencies(ra, ia, rb, ib, alpha, n_max):
    """Qext, Qsca, g from the coefficient arrays (``src/SOS_MIE.F:602-632``)."""
    ns = jnp.arange(1, n_max + 1, dtype=alpha.dtype)
    sgn = jnp.where(ns % 2 == 1, -1.0, 1.0)    # J starts at -1 for n=1
    a2 = ns + 1.0
    qext = jnp.sum(ns * a2 * sgn * (ia - ib))
    qsca = jnp.sum(ns * ns * a2 * a2 / (ns + a2)
                   * (ra * ra + ia * ia + rb * rb + ib * ib))
    ra_n = jnp.concatenate([ra[1:], jnp.zeros_like(ra[:1])])
    ia_n = jnp.concatenate([ia[1:], jnp.zeros_like(ia[:1])])
    rb_n = jnp.concatenate([rb[1:], jnp.zeros_like(rb[:1])])
    ib_n = jnp.concatenate([ib[1:], jnp.zeros_like(ib[:1])])
    g = -jnp.sum(a2 * ns / (a2 + ns)
                 * (ns * (a2 + 1.0) ** 2 / (2.0 * ns + 3.0)
                    * (ia * ia_n + ra * ra_n + ib * ib_n + rb * rb_n)
                    + ia * ib + ra * rb))
    w6 = 2.0 / alpha / alpha
    qext = w6 * qext
    qsca = w6 * qsca
    g = 4.0 * g / qsca / alpha / alpha
    return qext, qsca, g


@partial(jax.jit, static_argnames=("n_max",))
def mie_batch(alphas, rn, in_, pi_t, tau_t, n_max: int) -> MieResult:
    """Mie quantities for a batch of size parameters.

    ``pi_t``/``tau_t``: (n_max, D) angular tables from ``pi_tau_tables``.
    The coefficient build is vmapped over alpha; the amplitude sums are
    batched matmuls.
    """
    def coeffs(a):
        ra, ia, rb, ib, _ = _an_bn(a, rn, in_, n_max)
        qext, qsca, g = _efficiencies(ra, ia, rb, ib, a, n_max)
        return ra, ia, rb, ib, qext, qsca, g

    ra, ia, rb, ib, qext, qsca, g = jax.vmap(coeffs)(alphas)

    # S1/S2 for every alpha and angle: (A, N) @ (N, D)
    dt = alphas.dtype
    res1 = -(ia @ pi_t + ib @ tau_t)
    ims1 = ra @ pi_t + rb @ tau_t
    res2 = ia @ tau_t + ib @ pi_t
    ims2 = -(ra @ tau_t + rb @ pi_t)

    coef = (2.0 / (qsca * alphas ** 2))[:, None]
    y1 = res1 * res1 + ims1 * ims1
    y2 = res2 * res2 + ims2 * ims2
    y3 = 2.0 * res2 * res1
    y4 = 2.0 * ims2 * ims1
    imie = coef * (y1 + y2)
    qmie = coef * (y2 - y1)
    umie = coef * (y3 + y4)
    return MieResult(alpha=alphas, qext=qext, qsca=qsca, g=g,
                     imie=imie, qmie=qmie, umie=umie)


def series_order(alpha_max: float) -> int:
    """N1 bound of the reference: 2*alpha + 20 (``src/SOS_MIE.F:422``)."""
    n1 = int(2 * alpha_max + 20)
    if n1 > cte.MIE_DIM:
        raise ValueError("alpha_max too large for CTE_MIE_DIM")
    return n1


def run_mie_sweep(mu, rn, in_, alpha_min, alpha_max, batch: int = 256):
    """Full sweep over the reference alpha grid, bucketed for static shapes.

    Returns a MieResult with all alphas concatenated (host arrays).

    Always runs on the CPU backend with x64 enabled and float64 arrays
    (no dtype parameter — advisor r3): the Ricatti-Bessel recurrences need
    double precision (the reference is DOUBLE PRECISION throughout,
    ``src/SOS_MIE.F:205``) — in an f32 process the sweep would silently
    truncate and overflow to NaN extinction sections, which then poisons
    the whole pipeline (setup is float64 per the project precision policy;
    only the solve drops to f32).  Running it on the CPU backend is host
    set-up by design, not a fallback: the accelerator runs the solve.
    """
    cpu0 = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu0):
        return _run_mie_sweep_f64(mu, rn, in_, alpha_min, alpha_max,
                                  batch, jnp.float64)


def _run_mie_sweep_f64(mu, rn, in_, alpha_min, alpha_max, batch, dtype):
    alphas = alpha_sweep(alpha_min, alpha_max)
    # bucket boundaries chosen so n_max within a bucket is tight
    edges = [0.0, 1.0, 10.0, 30.0, 100.0, 300.0, 1000.0, 4000.0, np.inf]
    outs = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (alphas >= lo) & (alphas < hi)
        if not np.any(sel):
            continue
        sub = alphas[sel]
        n_max = series_order(float(sub.max()))
        pi_t, tau_t = pi_tau_tables(mu, n_max)
        pi_j = jnp.asarray(pi_t, dtype=dtype)
        tau_j = jnp.asarray(tau_t, dtype=dtype)
        for i in range(0, len(sub), batch):
            chunk = sub[i: i + batch]
            pad = (-len(chunk)) % batch
            if pad:
                chunk = np.concatenate([chunk, np.full(pad, chunk[-1])])
            res = mie_batch(jnp.asarray(chunk, dtype=dtype), rn, in_,
                            pi_j, tau_j, n_max)
            res = jax.tree.map(np.asarray, res)
            if pad:
                res = jax.tree.map(lambda a: a[: len(sub[i: i + batch])], res)
            outs.append(res)
    cat = lambda xs: np.concatenate(xs, axis=0)
    return MieResult(*[cat([getattr(o, f) for o in outs])
                       for f in MieResult._fields])


#: optional Mie-sweep observer: when proc.run is writing an ``-AER.MieLog``
#: it sets this to a list and every (possibly cache-served) sweep appends a
#: summary dict — the source of the per-alpha trace narration
#: (``src/SOS_MIE.F:341-387``)
SWEEP_LOG = None


def run_mie_sweep_cached(mu, rn, in_, alpha_min, alpha_max,
                         batch: int = 256) -> MieResult:
    """``run_mie_sweep`` through the product cache (the reference's Mie-file
    memoization, ``src/SOS_AEROSOLS.F:1233-1260``); identity call when no
    cache directory is configured."""
    from .cache import memo
    params = dict(mu=np.asarray(mu), rn=float(rn), in_=float(in_),
                  amin=float(alpha_min), amax=float(alpha_max))
    out = memo("mie", params,
               lambda: run_mie_sweep(mu, rn, in_, alpha_min, alpha_max,
                                     batch)._asdict())
    res = MieResult(**out)
    if SWEEP_LOG is not None:
        SWEEP_LOG.append(dict(rn=float(rn), in_=float(in_),
                              alpha=np.asarray(res.alpha),
                              qext=np.asarray(res.qext),
                              qsca=np.asarray(res.qsca),
                              g=np.asarray(res.g)))
    return res
