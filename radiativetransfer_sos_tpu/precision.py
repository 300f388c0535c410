"""Precision policy of the solver, and the f32-vs-f64 gate.

**Policy** (SURVEY.md §7 hard part (d)): the reference is double precision
throughout with stop thresholds down to 1e-50 (``inc/SOS.h:395,418``).
Here:

* all *setup* math (angle grids, GSF bases, Mie, surface matrices, CKD
  interpolation, profile discretization) runs in float64 NumPy;
* the *solver* runs in the dtype of its inputs — float32 on the GPU for
  speed, float64 on the CPU for oracle tests and under the CLI, which
  enables x64;
* convergence thresholds are clamped to the representable range of the
  field dtype: ``SEUIL_VALDIF = 1e-50`` underflows float32, so the
  absolute stop test degrades to an exact-zero test there (``solver``
  clamps it to ``finfo.tiny``), which keeps the semantics — the test
  exists to stop dead fields, not to measure 1e-50 radiances;
* the scattering-source matmul accumulates in the field dtype
  (``preferred_element_type``); on an NVIDIA GPU a float32 matmul at
  DEFAULT precision multiplies in TF32 with float32 accumulation, which
  the gate below validates against float64.

**Gate**: :func:`compare_dtypes` runs the *same* pinned demo-shape solve
(NT=600, IBORM=80, NBMU=41 — the shape of one CKD term of the reference
demo ``exe/runSOS-ABS_demo.ksh``) in float32 and float64 and reports the
worst relative I/Q/U disagreement above an absolute floor.
``chip_smoke.py`` runs it on the GPU and fails when the answers drift;
``tests/test_precision.py`` runs it on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

#: radiances below this (in normalized sr^-1) are noise for the rel-error
#: metric — the reference itself zeroes |Q|,|U| < 1e-15 at output
#: (src/SOS_TRPHI.F:1212-1218) and demo fields are O(1e-2..1e-1)
REL_FLOOR = 1.0e-6

#: acceptance thresholds for the f32 path vs the CPU f64 oracle on the
#: pinned demo-shape case, in allclose form |f32 - f64| <= ATOL + RTOL*|f64|.
#: Measured on an NVIDIA H100 (TF32 scatter matmuls, the sweep kernel):
#: max abs error 1.14e-5, max rel error 5.5e-4, 2% of the allowed
#: deviation (``tol_ratio`` 0.0197, ``chip_smoke.py`` phase b).
F32_REL_TOL = 5.0e-3
F32_ABS_TOL = 5.0e-6


class DemoProblem(NamedTuple):
    inp: object           # solver.SolveInputs (term-batched)
    opt: object           # solver.SolveOptions
    n_terms: int


def demo_problem(dtype, n_gauss: int = 40, nt: int = 600, os_nb: int = 80,
                 igmax: int = 30, n_terms: int = 4,
                 rho: float = 0.1) -> DemoProblem:
    """Pinned demo-shape solve inputs (one CKD term of the reference demo,
    ``exe/runSOS-ABS_demo.ksh`` with ``src/SOS.F:546-550`` bounds).

    Setup math is float64; operands are cast to ``dtype`` at the end (the
    production precision policy).  Deterministic: seeded profile jitter.
    """
    import jax.numpy as jnp

    from . import angles, gsf, kernels, solver

    grid = angles.make_radiance_grid(35.0, n_gauss=n_gauss)
    psl, rsl, tsl = gsf.gsf_basis(grid.mu, grid.mus, os_nb, os_nb + 1)
    psl, rsl, tsl = (jnp.asarray(a, dtype=dtype) for a in (psl, rsl, tsl))
    ll = np.arange(os_nb + 1)
    beta = (2 * ll + 1.0) * 0.7 ** ll
    gamma = np.where(ll >= 2, -0.1 * beta, 0.0)
    alpha = np.where(ll >= 2, 0.2 * beta, 0.0)
    zeta = np.where(ll >= 2, 0.05 * beta, 0.0)
    k_aer = kernels.aerosol_kernel(psl, rsl, tsl, alpha, beta, gamma, zeta)
    k_mol = kernels.molecular_kernel(psl, rsl, tsl, 0.0279)

    h0 = np.linspace(0.0, 1.0, nt + 1) ** 1.2 * 0.5
    rng = np.random.default_rng(0)
    h_b = h0[None, :] * (1.0 + 0.3 * rng.random((n_terms, 1)))
    xdel = np.full((n_terms, nt + 1), 0.45)
    ydel = 1.0 - xdel

    inp = solver.SolveInputs(
        h=jnp.asarray(h_b, dtype=dtype),
        xdel=jnp.asarray(xdel, dtype=dtype),
        ydel=jnp.asarray(ydel, dtype=dtype),
        k_aer=k_aer, k_mol=k_mol,
        mu_pos=jnp.asarray(grid.mu, dtype=dtype),
        w_pos=jnp.asarray(grid.w, dtype=dtype),
        tab=jnp.asarray(grid.mus, dtype=dtype), n0=grid.imus,
        surface=solver.SurfaceInputs(rho=jnp.asarray(rho, dtype=dtype)))
    opt = solver.SolveOptions(igmax=igmax)
    return DemoProblem(inp=inp, opt=opt, n_terms=n_terms)


def _solve(problem: DemoProblem):
    from . import solver

    res = solver.solve_fourier_batch_jit(problem.inp, problem.opt)
    return np.asarray(res.i3bnd, dtype=np.float64)


def rel_err(a: np.ndarray, b: np.ndarray,
            floor: float = REL_FLOOR) -> float:
    """Worst |a-b| / max(|b|, floor) over the Stokes records."""
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), floor)))


def cpu_reference(n_gauss: int = 40, nt: int = 600, os_nb: int = 80,
                  igmax: int = 30, n_terms: int = 1) -> np.ndarray:
    """Boundary records (T, S, 3, D) of the pinned case solved in float64
    on the CPU backend.

    This is the reference, an implementation independent of the device
    path (the associative-scan sweep, float64 matmuls); running it on the
    CPU is by design, not a fallback.
    """
    import jax
    import jax.numpy as jnp

    cpu0 = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu0):
        return _solve(demo_problem(jnp.float64, n_gauss=n_gauss, nt=nt,
                                   os_nb=os_nb, igmax=igmax,
                                   n_terms=n_terms))


def tol_ratio(got: np.ndarray, want: np.ndarray) -> float:
    """Worst ``|got - want| / (F32_ABS_TOL + F32_REL_TOL * |want|)``: the
    gate's allclose criterion holds when this is <= 1."""
    return float(np.max(np.abs(got - want)
                        / (F32_ABS_TOL + F32_REL_TOL * np.abs(want))))


def compare_dtypes(n_gauss: int = 40, nt: int = 600, os_nb: int = 80,
                   igmax: int = 30, n_terms: int = 1,
                   i64: np.ndarray = None) -> dict:
    """Solve the pinned case in f32 (production backend) and f64 (host CPU,
    :func:`cpu_reference`; pass ``i64`` to reuse one) and report the
    disagreement.

    The f32 arm runs wherever production runs (the default backend), i.e.
    the sweep kernel on a GPU.  Returns ``{"max_rel_err", "max_abs_err",
    "tol_ratio", "ok"}``; ``ok`` applies the allclose criterion
    (:func:`tol_ratio` <= 1).
    """
    import jax.numpy as jnp

    kw = dict(n_gauss=n_gauss, nt=nt, os_nb=os_nb, igmax=igmax,
              n_terms=n_terms)
    if i64 is None:
        # x64 is scoped to the f64 arm: the f32 production path must be
        # measured exactly as it ships
        i64 = cpu_reference(**kw)
    i32 = _solve(demo_problem(jnp.float32, **kw))
    ratio = tol_ratio(i32, i64)
    return {
        "max_rel_err": rel_err(i32, i64),
        "max_abs_err": float(np.max(np.abs(i32 - i64))),
        "tol_ratio": ratio,
        "ok": ratio <= 1.0,
    }
