"""On-device acceptance checks of the solve path.

Each check runs one layer or one entry point on the default device (the
GPU, under ``chip_smoke.py`` and the ``gpu``-marked tests) at a size its
caller chooses, compares the result with the repository's plain reference
on the CPU backend, and returns a flat record::

    {"dtype", "seconds", "err", "limit", "ok", ...}

``err`` is the check's worst error and ``limit`` the bound it must stay
under (``ok``).  Wall times end in ``block_until_ready``.  The CPU
references run in float64 under ``jax.enable_x64``; the device arms run
in the dtype the caller's process uses (float32 unless x64 is on).
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from . import memplan, precision, solver


def _cpu():
    return jax.devices("cpu")[0]


def _wall(fn, reps=3):
    """Median wall time of ``fn()`` (its result blocked on), after one
    warm-up call; returns (seconds, last result)."""
    out = jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def _sweep_case(key, n_orders, n_terms, nt, hp, dtype):
    """Random sweep operands on the default device: per-term depths with
    16 zero-thickness pad layers at the bottom (the profile pad), source
    and ground boundary of the (S*T) instance batch."""
    lp = solver.pad_levels(nt)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    dh = jax.random.uniform(k1, (n_terms, nt), dtype, 1e-4, 5e-2)
    dh = dh.at[:, nt - 16:].set(0.0)
    h = jnp.concatenate([jnp.zeros((n_terms, 1), dtype),
                         jnp.cumsum(dh, axis=1)], axis=1)
    h = jnp.pad(h, ((0, 0), (0, lp - nt - 1)), mode="edge")
    muh = jnp.concatenate([jax.random.uniform(k2, (hp - 2,), dtype, 0.05,
                                              1.0), jnp.ones((2,), dtype)])
    b_n = n_orders * n_terms
    src = jax.random.normal(k3, (b_n, lp, 2 * hp), dtype)
    bc = jax.random.normal(k4, (b_n, hp), dtype)
    return h, muh, src, bc


def sweep_check(n_orders=8, n_terms=512, nt=600, hp=128, n_ref=64, seed=0):
    """The layer sweep of the solve (``solver._sweep_batched``) at
    (S*T, LP, 2*HP) on the default device, in float32, against
    ``_sweep_flat_scan`` in float64 on the CPU for the first ``n_ref``
    instances.  Rule (the CPU suite's): its worst error is within 4x the
    float32 scan's own, plus 1e-6.  A float64 run of the same kernel must
    match the float64 reference to 1e-10 of the field's scale."""
    key = jax.random.PRNGKey(seed)
    h, muh, src, bc = _sweep_case(key, n_orders, n_terms, nt, hp,
                                  jnp.float32)
    run = jax.jit(solver._sweep_batched)
    secs, out = _wall(lambda: run(h, muh, src, bc))
    got = np.asarray(out[:n_ref])

    t_ref = np.arange(n_ref) % n_terms
    h_r = np.asarray(h)[t_ref]
    muh_r, src_r, bc_r = (np.asarray(x) for x in (muh, src[:n_ref],
                                                  bc[:n_ref]))
    scan = jax.jit(jax.vmap(solver._sweep_flat_scan,
                            in_axes=(0, None, 0, 0)))
    with jax.default_device(_cpu()):
        scan32 = np.asarray(scan(h_r, muh_r, src_r, bc_r))
        with jax.enable_x64(True):
            want = np.asarray(scan(*(np.asarray(x, np.float64)
                                     for x in (h_r, muh_r, src_r, bc_r))))
    err = float(np.max(np.abs(got - want)))
    err_scan = float(np.max(np.abs(scan32 - want)))
    limit = 4.0 * err_scan + 1e-6

    with jax.enable_x64(True):
        d64 = [jnp.asarray(x, jnp.float64) for x in (h_r, muh_r, src_r,
                                                     bc_r)]
        got64 = np.asarray(run(d64[0][:n_ref], *d64[1:]))
    err64 = float(np.max(np.abs(got64 - want)))
    limit64 = 1e-10 * float(np.max(np.abs(want)))
    return {"dtype": "float32", "seconds": secs, "err": err,
            "limit": limit, "err_f32_scan": err_scan,
            "err_f64": err64, "limit_f64": limit64,
            "ok": bool(err <= limit and err64 <= limit64),
            "shape": list(src.shape)}


def scatter_check(n_orders=8, n_terms=512, nt=600, hp=128, n_ref=8,
                  seed=1):
    """The scattering-source matmul of the solve (``solver._scatter_source``,
    default precision: TF32 on an NVIDIA GPU) at (S, T, LP, 2*HP) against
    a float64 NumPy einsum on the first ``n_ref`` terms.

    Limit, elementwise: ``|C - C64| <= 2e-3 * (|A| @ |B|)``.  Rounding
    both TF32 operands (10-bit mantissa) costs at most 2 * 2^-11 = 9.8e-4
    of each product, and f32 accumulation over K = 4*HP terms another
    K * 2^-24; 2e-3 bounds both with margin at K = 512.
    """
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    lp = solver.pad_levels(nt)
    w = 2 * hp
    fld = jax.random.normal(k1, (n_orders, n_terms, lp, w), jnp.float32)
    xdel = jax.random.uniform(k2, (n_terms, lp), jnp.float32)
    ydel = 1.0 - xdel
    mboth = jax.random.normal(k3, (n_orders, 2 * w, w), jnp.float32) * 0.05
    run = jax.jit(solver._scatter_source)
    secs, out = _wall(lambda: run(fld, xdel, ydel, mboth))

    compiled = run.lower(fld, xdel, ydel, mboth).compile()
    temp = int(compiled.memory_analysis().temp_size_in_bytes)
    hlo = compiled.as_text()
    operand_bytes = 2 * fld.size * 4

    f = np.asarray(fld[:, :n_ref], np.float64)
    x = np.asarray(xdel[:n_ref], np.float64)[None, :, :, None]
    y = np.asarray(ydel[:n_ref], np.float64)[None, :, :, None]
    mb = np.asarray(mboth, np.float64)
    f2 = np.concatenate([x * f, y * f], axis=-1)
    want = np.einsum("stlk,skj->stlj", f2, mb)
    bound = np.einsum("stlk,skj->stlj", np.abs(f2), np.abs(mb))
    got = np.asarray(out[:, :n_ref], np.float64)
    ratio = float(np.max(np.abs(got - want) / bound))
    flops = 2.0 * n_orders * n_terms * lp * (2 * w) * w
    return {"dtype": "float32", "seconds": secs, "err": ratio,
            "limit": 2e-3, "ok": bool(ratio <= 2e-3),
            "tflops": flops / secs / 1e12, "temp_bytes": temp,
            "mixed_operand_bytes": operand_bytes,
            "operand_materialized": bool(temp >= operand_bytes),
            "cublas_gemms": hlo.count("__cublas$gemm"),
            "triton_gemms": hlo.count("__triton_gemm"),
            "shape": list(fld.shape)}


#: what ``err`` means where a check applies the gate's criterion
_GATE_RULE = "max |f32-f64| / (%g + %g*|f64|)" % (precision.F32_ABS_TOL,
                                                 precision.F32_REL_TOL)


def precision_gate(i64=None, **kw):
    """``precision.compare_dtypes`` at the demo shape (NT 600, IBORM 80,
    NBMU 40 + sun): f32 on the default device vs f64 on the CPU."""
    t0 = time.perf_counter()
    r = precision.compare_dtypes(i64=i64, **kw)
    return {"dtype": "float32", "seconds": time.perf_counter() - t0,
            "err": r["tol_ratio"], "limit": 1.0, "ok": r["ok"],
            "max_rel_err": r["max_rel_err"],
            "max_abs_err": r["max_abs_err"], "rule": _GATE_RULE}


def blocked_solve_check(n_terms=512, i64=None, n_gauss=40, nt=600,
                        os_nb=80):
    """Production-scale blocked solve: a demo-shape batch of ``n_terms``
    terms through ``solve_fourier_blocked_chunked`` on the default device
    (f32), the planner-picked executable compiled ahead of time and its
    ``memory_analysis()`` held to ``memplan.estimate_bytes`` (an upper
    bound) and to the device's ``bytes_limit``; term 0 against the CPU f64
    all-orders records ``i64`` (computed here when None) at the gate's
    tolerance on the orders the reference keeps."""
    kw = dict(n_gauss=n_gauss, nt=nt, os_nb=os_nb)
    prob = precision.demo_problem(jnp.float32, n_terms=n_terms, **kw)
    inp, opt = prob.inp, prob.opt
    dev = jax.devices()[0]
    n_mu = inp.mu_pos.shape[0]
    n_orders = inp.k_aer.shape[0]
    block, chunk = memplan.pick_dispatch(
        n_terms, n_orders, nt, n_mu, use_zout=opt.use_zout,
        imat_surf=opt.imat_surf, device=dev)

    # the executable the blocked driver dispatches: block orders x chunk
    # terms with the absolute order carried in is0
    is0 = jnp.zeros((block,), jnp.float32).at[0].set(1.0)
    inp_b = inp._replace(h=inp.h[:chunk], xdel=inp.xdel[:chunk],
                         ydel=inp.ydel[:chunk], k_aer=inp.k_aer[:block],
                         k_mol=inp.k_mol[:block], is0=is0)
    ma = solver.solve_fourier_batch_jit.lower(inp_b, opt).compile() \
        .memory_analysis()
    used = (ma.temp_size_in_bytes + ma.argument_size_in_bytes
            + ma.output_size_in_bytes)
    est = memplan.estimate_bytes(block, chunk, nt, n_mu, opt.use_zout,
                                 opt.imat_surf)
    hbm = memplan.device_hbm(dev)
    field = block * chunk * solver.pad_levels(nt) * solver._half_pad(n_mu) * 4

    t0 = time.perf_counter()
    jax.block_until_ready(
        solver.solve_fourier_blocked_chunked(inp, opt).i3bnd)
    cold = time.perf_counter() - t0
    secs, res = _wall(lambda: solver.solve_fourier_blocked_chunked(
        inp, opt).i3bnd, reps=2)
    got = np.asarray(res, np.float64)

    if i64 is None:
        i64 = precision.cpu_reference(**kw)
    ref = i64[0]
    n_got = min(got.shape[1], ref.shape[0])
    mask = np.asarray(solver.fourier_stop_mask(ref))[:n_got]
    a, b = got[0, :n_got][mask], ref[:n_got][mask]
    err = precision.tol_ratio(a, b)
    ok = (bool(np.all(np.isfinite(got))) and err <= 1.0
          and used <= est and used < hbm)
    return {"dtype": "float32", "seconds": secs, "compile_s": cold - secs,
            "terms_per_s": n_terms / secs, "err": err, "limit": 1.0,
            "rule": _GATE_RULE, "ok": ok,
            "block": block, "term_chunk": chunk, "xla_bytes": int(used),
            "estimate_bytes": int(est), "bytes_limit": int(hbm),
            "field_multiple": used / field,
            "orders_dispatched": int(got.shape[1])}


def ocean_demo_config(nbmu=40, thetas=35.0, aot=0.3, surface_type=1,
                      alb=0.0, view=2, solar_in_grid=True):
    """The polarized ocean demo (``exe/runSOS-ABS_demoPolar.ksh``,
    ``demos/configs.py``) at its published settings: 765 nm, NBMU 40,
    theta_s 35 deg, Cox-Munk glitter (wind 2 m/s, n = 1.34, albedo 0),
    HR 8 / HA 2 km, AOT 0.3 at 550 nm, a polar view with a 30 deg step.
    Two substitutions: a table-free IMOD 0 log-normal aerosol (r = 0.2 um,
    ln sigma = 0.4, m = 1.44) replaces WMO maritime, and there is no gas
    (``absprofil = 7``)."""
    from .config import (AbsConfig, AerosolConfig, AngleConfig,
                         MonoModalAerosol, ProfileConfig, SosConfig,
                         SurfaceConfig, ViewConfig)
    surf = (SurfaceConfig(type=1, alb=alb, ind=1.34, wind=2.0)
            if surface_type == 1 else SurfaceConfig(type=0, alb=alb))
    return SosConfig(
        wavelength=0.765,
        angles=AngleConfig(nbmu_lum=nbmu, thetas_deg=thetas,
                           solar_in_grid=solar_in_grid),
        aerosols=AerosolConfig(
            aot_ref=aot, waref=0.550, model=0,
            mm=MonoModalAerosol(sdtype=1, lnd_radius=0.2, lnd_var=0.4,
                                mr_wa=1.44, mi_wa=-0.0, mr_waref=1.44,
                                mi_waref=-0.0)),
        surface=surf, profile=ProfileConfig(hr=8.0, ha=2.0),
        absorption=AbsConfig(absprofil=7),
        view=ViewConfig(itrphi=view, dphi_deg=30))


def _iqu(res):
    return np.stack([np.asarray(res.up[k], np.float64)
                     for k in ("i", "q", "u")])


def demo_polar_check(nbmu=40):
    """The main path, ``proc.sos_run``, on the polarized ocean demo
    (:func:`ocean_demo_config`): f32 on the default device against the
    same case in f64 on the CPU, I/Q/U tables at the gate's tolerance."""
    from . import proc

    cfg = ocean_demo_config(nbmu=nbmu)
    proc.sos_run(cfg)                              # compile
    t0 = time.perf_counter()
    res = proc.sos_run(cfg)
    secs = time.perf_counter() - t0
    got = _iqu(res)
    # the phase-operator memo holds device arrays of the first run's
    # dtype and device
    proc._kernels_cached.cache_clear()
    with jax.enable_x64(True), jax.default_device(_cpu()):
        want = _iqu(proc.sos_run(cfg))
    proc._kernels_cached.cache_clear()
    err = precision.tol_ratio(got, want)
    return {"dtype": str(jnp.asarray(0.0).dtype), "seconds": secs,
            "err": err, "limit": 1.0, "rule": _GATE_RULE,
            "max_rel_err": precision.rel_err(got, want),
            "ok": bool(err <= 1.0 and np.all(np.isfinite(got))),
            "shape": list(got.shape), "n_orders": int(res.records_up.shape[0])}


def lut_check(nbmu=40, n_aot=8, n_alb=4, thetas=(20.0, 35.0, 50.0, 65.0)):
    """The LUT factory, ``lut.sos_run_many(batch_cases=True)``, on the
    default device: an AOT x albedo sweep of the ocean demo atmosphere
    over a Lambertian ground (cases share kernels: the flatten path) and
    a theta_s sweep with ``solar_in_grid=False`` (one multiband group).
    A validation slice of two cases of each is re-solved case by case
    (the sequential path) and must agree to rtol 1e-5 / atol 1e-7 on I
    and rtol 1e-4 / atol 1e-7 on Q."""
    from . import lut

    base = ocean_demo_config(nbmu=nbmu, surface_type=0, view=1)
    flat = lut.sweep_configs(base, {
        "aerosols.aot_ref": list(np.linspace(0.05, 0.5, n_aot)),
        "surface.alb": list(np.linspace(0.0, 0.3, n_alb))})
    sun = lut.sweep_configs(
        ocean_demo_config(nbmu=nbmu, surface_type=0, alb=0.1, view=1,
                          solar_in_grid=False),
        {"angles.thetas_deg": list(thetas)})
    cases = flat + sun
    t0 = time.perf_counter()
    bat = lut.sos_run_many(cases, batch_cases=True)
    secs = time.perf_counter() - t0
    pick = [0, len(flat) - 1, len(flat), len(cases) - 1]
    seq = lut.sos_run_many([cases[i] for i in pick])
    err, ok = 0.0, True
    for i, rs in zip(pick, seq):
        rb = bat[i]
        for k, rtol in (("i", 1e-5), ("q", 1e-4)):
            a, b = np.asarray(rb.up[k]), np.asarray(rs.up[k])
            err = max(err, float(np.max(np.abs(a - b)
                                        / (1e-7 + rtol * np.abs(b)))))
            ok &= bool(np.all(np.isfinite(a)))
    return {"dtype": str(jnp.asarray(0.0).dtype), "seconds": secs,
            "cases_per_s": len(cases) / secs, "n_cases": len(cases),
            "err": err, "limit": 1.0, "ok": bool(ok and err <= 1.0)}


def _demo_f32(n_terms, **kw):
    return precision.demo_problem(jnp.float32, n_terms=n_terms, **kw)


def sharded_blocked_check(n_terms=512, **kw):
    """``parallel.solve_terms_sharded_blocked`` on ``make_mesh(4, 1)`` (the
    blocked Fourier early exit over a term-sharded mesh, as ``proc.run(
    mesh=...)`` dispatches it) against the same batch solved by
    ``solve_fourier_blocked`` on one device.  Records of the orders the
    one-device stop keeps must agree to ``1e-6 + 1e-4*|x|`` (f32 sums
    taken in another order: another GEMM shape per device)."""
    from .parallel import make_mesh, solve_terms_sharded_blocked

    prob = _demo_f32(n_terms, **kw)
    one = jax.block_until_ready(
        solver.solve_fourier_blocked(prob.inp, prob.opt).i3bnd)
    mesh = make_mesh(4, 1)
    t0 = time.perf_counter()
    four = jax.block_until_ready(
        solve_terms_sharded_blocked(mesh, prob.inp, prob.opt).i3bnd)
    cold = time.perf_counter() - t0
    secs, four = _wall(lambda: solve_terms_sharded_blocked(
        mesh, prob.inp, prob.opt).i3bnd, reps=2)
    a, b = np.asarray(four, np.float64), np.asarray(one, np.float64)
    n_s = min(a.shape[1], b.shape[1])
    keep = np.asarray(jax.vmap(solver.fourier_stop_mask)(b))[:, :n_s]
    a, b = a[:, :n_s], b[:, :n_s]
    ratio = np.abs(a - b) / (1e-6 + 1e-4 * np.abs(b))
    err = float(np.max(np.where(keep[:, :, None, None], ratio, 0.0)))
    return {"dtype": "float32", "seconds": secs, "compile_s": cold - secs,
            "terms_per_s": n_terms / secs, "err": err, "limit": 1.0,
            "ok": bool(err <= 1.0 and np.all(np.isfinite(a))),
            "mesh": "scene=4,fourier=1"}


def sharded_reduce_check(n_terms=16, **kw):
    """``parallel.solve_terms_sharded`` on ``make_mesh(2, 2)`` (terms over
    ``scene``, Fourier orders over ``fourier``, IS = 0 fluxes ``psum``-ed)
    followed by the AIK reduction ``ckd_reduce`` across the mesh, against
    the one-device all-orders solve reduced by a float64 NumPy einsum;
    limit ``1e-6 + 1e-4*|x|`` as in :func:`sharded_blocked_check`."""
    from .parallel import ckd_reduce, make_mesh, solve_terms_sharded

    prob = _demo_f32(n_terms, **kw)
    w = np.linspace(1.0, 2.0, n_terms)
    w = w / w.sum()
    one = solver.solve_fourier_batch_jit(prob.inp, prob.opt)
    want = np.einsum("t,tscd->scd", w, np.asarray(one.i3z, np.float64))
    want_e = float(w @ np.asarray(one.emoins, np.float64))
    mesh = make_mesh(2, 2)

    def run():
        res = solve_terms_sharded(mesh, prob.inp, prob.opt)
        with mesh:
            return ckd_reduce(jnp.asarray(w, jnp.float32), res.i3z,
                              res.emoins, res.eplus)

    secs, (i3z, emoins, _) = _wall(run, reps=2)
    got = np.asarray(i3z, np.float64)
    ratio = np.abs(got - want) / (1e-6 + 1e-4 * np.abs(want))
    err = max(float(np.max(ratio)),
              abs(float(emoins) - want_e) / (1e-6 + 1e-4 * abs(want_e)))
    return {"dtype": "float32", "seconds": secs, "err": err, "limit": 1.0,
            "ok": bool(err <= 1.0 and np.all(np.isfinite(got))),
            "mesh": "scene=2,fourier=2"}
