"""Batched production runs: the lookup-table workload.

The reference generates LUTs by shelling out one ``SOS_ABS_MAIN.exe``
process per (wavelength, geometry, aerosol, surface) case — every case
repeats the full property generation and pays a fresh process + file
pipeline (``exe/runSOS-ABS_demo.ksh``).  Here a sweep is a first-class
operation:

* one process, one jitted solver — the static shapes (angle count, layer
  grid, Fourier orders) are shared across the sweep, so the solver
  compiles once and every case reuses the executable;
* the per-case CKD-term batch can be sharded over a device mesh
  (``proc.run(..., mesh=...)``);
* Mie sweeps / surface matrices are memoized across cases through the
  product cache (``cache.memo``), the array equivalent of the reference's
  parameter-encoded product files;
* optional checkpointing: each finished case is written to a directory and
  skipped on resume — the coarse-grained recovery the reference gets from
  its cached product files and incremental aggregation file
  (``src/SOS_AGGREGATE.F:328-441``), SURVEY.md §5.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import os
import pickle
from typing import Callable, Iterable, Optional

from .config import SosConfig
from .proc import SosResults, sos_run


def case_key(cfg: SosConfig) -> str:
    """Content hash of one case — every physics parameter participates,
    like the reference's parameter-encoded file names
    (``SOS_NOM_FIC_SURFACE.F``)."""
    blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


def sweep_configs(base: SosConfig, axes: dict) -> list[SosConfig]:
    """Cartesian sweep: ``axes`` maps dotted config paths to value lists,
    e.g. ``{"wavelength": [...], "angles.thetas_deg": [...],
    "aerosols.aot_ref": [...]}``."""
    cases = [copy.deepcopy(base)]
    for path, values in axes.items():
        nxt = []
        for c in cases:
            for v in values:
                cc = copy.deepcopy(c)
                obj = cc
                *heads, leaf = path.split(".")
                for head in heads:
                    obj = getattr(obj, head)
                setattr(obj, leaf, v)
                nxt.append(cc)
        cases = nxt
    return cases


def sos_run_many(cfgs: Iterable[SosConfig], mesh=None,
                 checkpoint_dir: Optional[str] = None,
                 on_result: Optional[Callable[[int, SosConfig, SosResults],
                                              None]] = None,
                 trace=None, batch_cases: bool = False) -> list[SosResults]:
    """Run a batch of configurations, reusing the compiled solver.

    With ``checkpoint_dir``, each finished case is pickled under its
    content hash and skipped when re-running the same sweep (coarse
    resume).  ``on_result(i, cfg, res)`` streams results as they finish —
    in the batched path groups complete together, so indices may arrive
    out of order; checkpoint-loaded cases are delivered up front.

    ``batch_cases=True`` solves compatible cases in ONE multiband device
    dispatch (``solver.solve_fourier_multiband``) instead of
    case-by-case: real 10 cm^-1 CKD bands carry only 1-10 exponential
    terms, far below the chip's saturation batch, so a spectral sweep
    solved per-case leaves most of the device idle.  Cases group by
    static solve shape (angle grid, Fourier orders, layer pad, options,
    surface structure); group sizes are capped by the memory planner.
    The solver records are identical to the sequential path (vmap is
    exact); the batched AGGREGATION runs on the device (HIGHEST
    precision) while small sequential cases aggregate on the host in
    f64, so in an f32 process final records can differ by a few 1e-8
    (on CPU both paths are f64 and bitwise equal).
    """
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
    cfg_list = list(cfgs)
    out: list[Optional[SosResults]] = [None] * len(cfg_list)
    pending: list[int] = []
    paths: list[Optional[str]] = [None] * len(cfg_list)
    for i, cfg in enumerate(cfg_list):
        if checkpoint_dir:
            paths[i] = os.path.join(checkpoint_dir, case_key(cfg) + ".pkl")
            if os.path.exists(paths[i]):
                with open(paths[i], "rb") as f:
                    out[i] = pickle.load(f)
                if on_result:
                    on_result(i, cfg, out[i])
                continue
        pending.append(i)

    def _store(i, res):
        if paths[i]:
            tmp = paths[i] + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(res, f)
            os.replace(tmp, paths[i])      # atomic, like the mv of C18
        out[i] = res
        if on_result:
            on_result(i, cfg_list[i], res)

    if batch_cases and mesh is None and len(pending) > 1:
        _run_batched(cfg_list, pending, _store, trace)
    else:
        for i in pending:
            _store(i, sos_run(cfg_list[i], trace=trace, mesh=mesh))
    return out


def _run_batched(cfg_list, pending, store, trace) -> None:
    """Prepare pending cases on the host, group by solve shape, solve each
    group multiband, finish per case."""
    import jax

    from . import memplan
    from .proc import (_narrate_convergence, dispatch_case, finish_case,
                       prepare_case, trphi_option)

    preps = {i: prepare_case(cfg_list[i], trace) for i in pending}

    def key(p):
        import numpy as np
        i = p.inp
        s = i.surface
        # mu/w participate BY CONTENT: the angle grid is shared across a
        # multiband group (vmap in_axes None), and two different solar
        # angles produce different grids with identical shapes.  Read
        # them from the HOST grid (p.lum) — hashing the device copies
        # costs two device round trips per case
        return (i.h.shape[1], p.iborm, i.n0, p.opt,
                np.ascontiguousarray(p.lum.mu).tobytes(),
                np.ascontiguousarray(p.lum.w).tobytes(),
                s.rmat is None, s.f11 is None, s.f12 is None,
                s.f33 is None, s.ind_surf is None, s.rmat_sun is None,
                p.use_zout, str(i.h.dtype))

    groups: dict = {}
    for i in pending:
        groups.setdefault(key(preps[i]), []).append(i)

    def fkey(p):
        # flatten eligibility: identical kernels, surface matrices and
        # sun geometry (host-side values only — no device fetches)
        return (p.kernel_key, p.surf_key, float(p.lum.mus),
                p.cfg.view.zout_km)

    for members in groups.values():
        if len(members) > 1:
            # cases that differ ONLY in profiles/AIK/albedo (spectral,
            # AOT, albedo sweeps) FLATTEN into one term axis and solve
            # at single-case dispatch speed — the vmapped multiband path
            # measures ~2x slower per instance (r5 lab)
            fgroups: dict = {}
            for i in members:
                fgroups.setdefault(fkey(preps[i]), []).append(i)
            rest = []
            for fs in fgroups.values():
                if len(fs) >= 2:
                    _solve_finish_flat(preps, fs, trace, store)
                else:
                    rest.extend(fs)
            members = rest
        if not members:
            continue
        if len(members) == 1:
            i = members[0]
            p = preps[i]
            res = dispatch_case(p, trace)
            store(i, trphi_option(p.cfg, finish_case(p, res, trace)))
            continue
        t_max = max(preps[i].inp.h.shape[0] for i in members)
        p0 = preps[members[0]].inp
        n_s = preps[members[0]].iborm + 1
        nt = p0.h.shape[1] - 1
        _, chunk = memplan.pick_dispatch(
            len(members) * t_max, n_s, nt, p0.mu_pos.shape[0],
            use_zout=preps[members[0]].use_zout,
            imat_surf=preps[members[0]].opt.imat_surf)
        if t_max > chunk:
            # per-case term counts exceed the planned chunk: a stacked
            # multiband dispatch would carry t_max unchunked terms — route
            # through the per-case dispatcher, whose blocked-chunked path
            # is planner-guarded (dispatch_case -> memplan)
            for i in members:
                p = preps[i]
                res = dispatch_case(p, trace)
                store(i, trphi_option(p.cfg, finish_case(p, res, trace)))
            continue
        # greedy sub-grouping over members SORTED by term count: every
        # case of a sub pads to the sub's max term count, so mixing a
        # 125-term band with 1-term bands would solve ~t_max/t_i
        # duplicates per small case (a 2.25 um sweep measured 3.5x padded
        # work, r5); sorting packs like-sized cases together, bounded by
        # the planner chunk
        order = sorted(members, key=lambda i: preps[i].inp.h.shape[0])
        subs, cur, cur_t = [], [], 0
        for i in order:
            t_i = preps[i].inp.h.shape[0]
            t_new = max(cur_t, t_i)
            if cur and (len(cur) + 1) * t_new > chunk:
                subs.append((cur, cur_t))
                cur, cur_t = [i], t_i
            else:
                cur.append(i)
                cur_t = t_new
        if cur:
            subs.append((cur, cur_t))
        for sub, t_sub in subs:
            _solve_finish_sub(preps, sub, t_sub, trace, store)


def _solve_finish_sub(preps, sub, t_max, trace, store) -> None:
    """One multiband dispatch + device aggregation + per-case finish.

    A ``RESOURCE_EXHAUSTED`` from the runtime (transient fragmentation or
    a co-tenant on the chip — the planner's own estimate fits) splits the
    sub-group in half and retries rather than killing the sweep.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from . import solver
    from .proc import (_aggregate_multiband_jit, _narrate_convergence,
                       finish_case, trphi_option)
    from .tracing import NullTrace

    tr = trace or NullTrace()
    try:
        with tr.stage("solve"):
            tr.event("multiband", n_cases=len(sub), t_max=t_max,
                     instances=len(sub) * t_max)
            res_mb = _solve_group([preps[i] for i in sub], t_max)
    except Exception as e:
        if "RESOURCE_EXHAUSTED" not in str(e) or len(sub) < 2:
            raise
        tr.event("multiband", oom_split=len(sub))
        half = len(sub) // 2
        for part in (sub[:half], sub[half:]):
            t_part = max(preps[i].inp.h.shape[0] for i in part)
            _solve_finish_sub(preps, part, t_part, trace, store)
        return
    # aggregate every case's records ON the device (padded terms carry
    # AIK weight 0), then ONE device->host transfer fetches the reduced
    # tables + the small per-term scalars — the full (C, T, S, 3, D)
    # records never leave the device
    with tr.stage("aggregate"):
        aik_pad = np.zeros((len(sub), t_max))
        for c, i in enumerate(sub):
            aik_pad[c, :preps[i].n_terms] = preps[i].aik
        recs_mb = _aggregate_multiband_jit(
            jnp.asarray(aik_pad, dtype=res_mb.i3z.dtype),
            res_mb.i3z, res_mb.i3bnd)
        use_zout = preps[sub[0]].use_zout
        recs_h, em_h, ep_h, to_h, ig_h, sc_h = jax.device_get(
            (recs_mb, res_mb.emoins, res_mb.eplus,
             res_mb.tauout if use_zout else None,
             res_mb.ig_last, res_mb.stop_code))
    for c, i in enumerate(sub):
        p = preps[i]
        nt_i = p.n_terms
        res_c = solver.FourierResult(
            i3z=None, i3bnd=None,
            emoins=em_h[c, :nt_i], eplus=ep_h[c, :nt_i],
            tauout=None if to_h is None else to_h[c, :nt_i],
            ig_last=None if ig_h is None else ig_h[c, :nt_i],
            stop_code=None if sc_h is None else sc_h[c, :nt_i])
        _narrate_convergence(p, res_c, tr)
        store(i, trphi_option(p.cfg, finish_case(
            p, res_c, trace, recs=recs_h[c])))


def _solve_finish_flat(preps, fset, trace, store) -> None:
    """Flattened solve of cases sharing kernels/surface/geometry.

    The cases' term axes concatenate into ONE (S, T_flat) grid — the same shape class as a single big CKD case,
    dispatched through the planner-guarded blocked-chunked driver.  The
    per-case albedo broadcasts as a per-term ``rho`` vector; per-case AIK
    aggregation is one device einsum with a (C, T_flat) weight matrix.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from . import solver
    from .proc import (_aggregate_cases_jit, _narrate_convergence,
                       _solve_batch, finish_case, trphi_option)
    from .tracing import NullTrace

    tr = trace or NullTrace()
    inps = [preps[i].inp for i in fset]
    counts = [int(i.h.shape[0]) for i in inps]
    offs = np.concatenate([[0], np.cumsum(counts)])
    t_flat = int(offs[-1])
    i0 = inps[0]

    def cat(get):
        return jnp.concatenate([get(i) for i in inps], axis=0)

    rho_flat = cat(lambda i: jnp.broadcast_to(
        jnp.asarray(i.surface.rho), (i.h.shape[0],)))
    inp_flat = i0._replace(
        h=cat(lambda i: i.h), xdel=cat(lambda i: i.xdel),
        ydel=cat(lambda i: i.ydel),
        surface=i0.surface._replace(rho=rho_flat),
        zprof=None if i0.zprof is None else cat(lambda i: i.zprof))

    p0 = preps[fset[0]]
    try:
        with tr.stage("solve"):
            tr.event("flatten", n_cases=len(fset), t_flat=t_flat)
            if p0.iborm + 1 > 24 and t_flat * (p0.iborm + 1) >= 1024:
                res = solver.solve_fourier_blocked_chunked(inp_flat,
                                                           p0.opt)
            else:
                res = _solve_batch(inp_flat, p0.opt, t_flat)
    except Exception as e:
        # transient RESOURCE_EXHAUSTED (shared chip / fragmentation):
        # split and retry, like the multiband sub-group path
        if "RESOURCE_EXHAUSTED" not in str(e) or len(fset) < 2:
            raise
        tr.event("flatten", oom_split=len(fset))
        half = len(fset) // 2
        for part in (fset[:half], fset[half:]):
            _solve_finish_flat(preps, part, trace, store)
        return

    with tr.stage("aggregate"):
        w = np.zeros((len(fset), t_flat))
        for c, i in enumerate(fset):
            w[c, offs[c]:offs[c] + preps[i].n_terms] = preps[i].aik
        recs_mb = _aggregate_cases_jit(
            jnp.asarray(w, dtype=res.i3z.dtype), res.i3z, res.i3bnd)
        use_zout = p0.use_zout
        recs_h, em_h, ep_h, to_h, ig_h, sc_h = jax.device_get(
            (recs_mb, res.emoins, res.eplus,
             res.tauout if use_zout else None,
             res.ig_last, res.stop_code))
    for c, i in enumerate(fset):
        p = preps[i]
        sl = slice(offs[c], offs[c] + p.n_terms)
        res_c = solver.FourierResult(
            i3z=None, i3bnd=None,
            emoins=np.asarray(em_h).reshape(-1)[sl],
            eplus=np.asarray(ep_h).reshape(-1)[sl],
            tauout=None if to_h is None
            else np.asarray(to_h).reshape(-1)[sl],
            ig_last=None if ig_h is None else ig_h[sl],
            stop_code=None if sc_h is None else sc_h[sl])
        _narrate_convergence(p, res_c, tr)
        store(i, trphi_option(p.cfg, finish_case(
            p, res_c, trace, recs=recs_h[c])))


def _null_trace():
    from .tracing import NullTrace
    return NullTrace()


def _solve_group(preps, t_max):
    """Stack a compatible case group (terms padded to ``t_max`` with
    term-0 duplicates, dropped after the solve) and dispatch multiband."""
    import jax.numpy as jnp

    from . import solver

    def pad_t(x):
        t = x.shape[0]
        if t == t_max:
            return x
        reps = jnp.broadcast_to(x[:1], (t_max - t,) + x.shape[1:])
        return jnp.concatenate([x, reps], axis=0)

    def stack(get):
        vals = [get(p.inp) for p in preps]
        if vals[0] is None:
            return None
        return jnp.stack(vals)

    inps = [p.inp for p in preps]
    c0 = inps[0]
    surf = solver.SurfaceInputs(
        rho=stack(lambda i: jnp.asarray(i.surface.rho)),
        rmat=stack(lambda i: i.surface.rmat),
        f11=stack(lambda i: i.surface.f11),
        f12=stack(lambda i: i.surface.f12),
        f33=stack(lambda i: i.surface.f33),
        ind_surf=stack(lambda i: i.surface.ind_surf),
        rmat_sun=stack(lambda i: i.surface.rmat_sun))
    stacked = c0._replace(
        h=jnp.stack([pad_t(i.h) for i in inps]),
        xdel=jnp.stack([pad_t(i.xdel) for i in inps]),
        ydel=jnp.stack([pad_t(i.ydel) for i in inps]),
        k_aer=stack(lambda i: i.k_aer),
        k_mol=stack(lambda i: i.k_mol),
        tab=stack(lambda i: jnp.asarray(i.tab)),
        surface=surf,
        zprof=stack(lambda i: None if i.zprof is None else pad_t(i.zprof)),
        zout_km=stack(lambda i: i.zout_km))
    opt = preps[0].opt
    c_n, t_n = len(preps), t_max
    n_s = stacked.k_aer.shape[1]
    if n_s <= 24 or c_n * t_n * n_s < 1024:
        # the all-orders dispatch is latency-optimal for small grids, but
        # its live set is block=n_s — validate the ACTUAL shape against
        # the memory budget before taking it (advisor r4: 16<n_s<=24 at a
        # full chunk could exceed the planner's block<=16 estimate)
        from . import memplan
        est = memplan.estimate_bytes(
            n_s, c_n * t_n, stacked.h.shape[-1] - 1,
            stacked.mu_pos.shape[0], use_zout=preps[0].use_zout,
            imat_surf=opt.imat_surf)
        if est <= memplan.budget_bytes(memplan.device_hbm()):
            return solver.solve_fourier_multiband_jit(stacked, opt)
    return solver.solve_fourier_multiband_blocked(stacked, opt)
