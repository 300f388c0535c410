"""f32-vs-f64 precision gate at the full demo shape (VERDICT round-1 #1).

The production GPU path runs the solver in float32 while every correctness
oracle runs float64; this gate pins their agreement at the flagship shape
(NT=600, IBORM=80, NBMU=41 — one CKD term of ``exe/runSOS-ABS_demo.ksh``).
``chip_smoke.py`` runs the same gate on the GPU (phase b).
"""

import numpy as np

from radiativetransfer_sos_tpu import precision


def test_f32_matches_f64_demo_shape():
    r = precision.compare_dtypes(n_terms=1)
    assert r["ok"], (
        f"f32 drift {r['max_rel_err']:.2e} exceeds "
        f"{precision.F32_REL_TOL:.0e} (abs {r['max_abs_err']:.2e})")
    # and the agreement is not vacuous (fields are non-trivial)
    assert r["max_abs_err"] > 0.0


def test_f32_threshold_clamp_no_infinite_loop():
    """In f32 SEUIL_VALDIF=1e-50 underflows; the clamp must keep the IG
    loop terminating on dead fields (zero kernels -> zero diffuse field)."""
    import jax.numpy as jnp

    prob = precision.demo_problem(jnp.float32, n_gauss=8, nt=20, os_nb=8,
                                  igmax=100, n_terms=1, rho=0.0)
    zero = prob.inp._replace(k_aer=jnp.zeros_like(prob.inp.k_aer),
                             k_mol=jnp.zeros_like(prob.inp.k_mol))
    from radiativetransfer_sos_tpu import solver
    res = solver.solve_fourier_batch_jit(zero, prob.opt)
    assert np.all(np.isfinite(np.asarray(res.i3bnd)))
    np.testing.assert_allclose(np.asarray(res.i3bnd), 0.0, atol=1e-30)
