"""Device-mesh scale-out for the scene/CKD batch.

The reference is a single-threaded Fortran pipeline whose only cross-solve
communication is the CKD weighted aggregation (``SOS_AGGREGATE``,
``src/SOS_AGGREGATE.F:372-441``, file streaming).  The exploitable structure
(SURVEY §2) maps onto a 2-D mesh:

* ``scene`` axis (data parallel): CKD exponential tuples x sun geometries x
  aerosol models — embarrassingly parallel solves; the AIK-weighted CKD
  reduction becomes one ``psum``-shaped einsum over this axis.
* ``fourier`` axis (model parallel): the Fourier orders of one solve are
  independent (``src/SOS_OS.F:872``); the leading S axis of every kernel and
  per-order field shards across chips, with only the tiny (S,3,D) boundary
  records gathered for the sequential stop-mask.

Shardings are expressed with ``jax.sharding.NamedSharding`` on jit
boundaries; XLA inserts the collectives (all-gather of boundary records,
all-reduce of the weighted sum), which run over NCCL between GPUs.
"""

from __future__ import annotations

import functools as _functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import solver


def make_mesh(n_scene: int, n_fourier: int, devices=None) -> Mesh:
    """(scene, fourier) mesh over the first n_scene*n_fourier devices."""
    if devices is None:
        devices = jax.devices()
    devs = np.asarray(devices[: n_scene * n_fourier]).reshape(
        n_scene, n_fourier)
    return Mesh(devs, ("scene", "fourier"))


def init_distributed() -> bool:
    """Initialize ``jax.distributed`` for a multi-host run.

    The scene axis of :func:`make_mesh` then spans hosts: lay the mesh out
    so the CKD/scene batch shards across hosts and the fourier axis stays
    within each host (SURVEY.md §5/§7.6 — the only cross-host
    communication of the workload is the AIK-weighted reduction).  No-op
    (returns False) when no coordinator is configured, so single-host runs
    and tests never touch the network.
    """
    import os

    addr = (os.environ.get("JAX_COORDINATOR_ADDRESS")
            or os.environ.get("COORDINATOR_ADDRESS"))
    if not addr:
        return False
    kwargs = {}
    n_proc = os.environ.get("JAX_NUM_PROCESSES")
    proc_id = os.environ.get("JAX_PROCESS_ID")
    if (n_proc is None) != (proc_id is None):
        raise ValueError(
            "JAX_NUM_PROCESSES and JAX_PROCESS_ID must be set together "
            f"(got NUM_PROCESSES={n_proc!r}, PROCESS_ID={proc_id!r}); "
            "unset both to use JAX cluster auto-detection")
    if n_proc is not None:
        # explicit manual-cluster layout (e.g. the 2-process CPU smoke
        # test, tests/test_distributed.py); without these JAX falls back
        # to its cluster auto-detection (e.g. Slurm)
        kwargs = dict(coordinator_address=addr,
                      num_processes=int(n_proc),
                      process_id=int(proc_id))
    jax.distributed.initialize(**kwargs)
    return True


def shard_solve_inputs(mesh: Mesh, inp: solver.SolveInputs,
                       batched: bool) -> solver.SolveInputs:
    """Place a (possibly scene-batched) SolveInputs onto the mesh.

    Kernels shard their Fourier axis; profile vectors are replicated (they
    are small); with ``batched`` the leading axis of every profile array is
    the scene axis.
    """
    b = ("scene",) if batched else ()

    def put(x, spec):
        if x is None:
            return None
        return jax.device_put(x, NamedSharding(mesh, P(*spec)))

    surf = inp.surface._replace(
        rho=put(inp.surface.rho, b),
        rmat=put(inp.surface.rmat, b + ("fourier",)),
        rmat_sun=put(inp.surface.rmat_sun, b + ("fourier",)),
        f11=put(inp.surface.f11, b), f12=put(inp.surface.f12, b),
        f33=put(inp.surface.f33, b))
    return inp._replace(
        h=put(inp.h, b + (None,)),
        xdel=put(inp.xdel, b + (None,)),
        ydel=put(inp.ydel, b + (None,)),
        k_aer=put(inp.k_aer, b + ("fourier",)),
        k_mol=put(inp.k_mol, b + ("fourier",)),
        mu_pos=put(inp.mu_pos, (None,)),
        w_pos=put(inp.w_pos, (None,)),
        tab=put(inp.tab, b),
        surface=surf)


@partial(jax.jit, static_argnames=("opt",))
def _solve_batch(inp: solver.SolveInputs, opt: solver.SolveOptions):
    """vmap of the Fourier solver over a leading scene axis."""

    def one(h, xdel, ydel, k_aer, k_mol, tab, rho, rmat):
        s = solver.SurfaceInputs(rho=rho, rmat=rmat)
        i = solver.SolveInputs(h=h, xdel=xdel, ydel=ydel, k_aer=k_aer,
                               k_mol=k_mol, mu_pos=inp.mu_pos,
                               w_pos=inp.w_pos, tab=tab, n0=inp.n0,
                               surface=s)
        return solver.solve_fourier(i, opt)

    return jax.vmap(one)(inp.h, inp.xdel, inp.ydel, inp.k_aer, inp.k_mol,
                         inp.tab, inp.surface.rho, inp.surface.rmat)


def solve_scenes_sharded(mesh: Mesh, inp: solver.SolveInputs,
                         opt: solver.SolveOptions) -> solver.FourierResult:
    """Solve a scene batch on the mesh; results stay sharded over 'scene'."""
    with mesh:
        return _solve_batch(inp, opt)


@jax.jit
def ckd_reduce(weights, i3z_batch, emoins_batch, eplus_batch):
    """AIK-weighted reduction over the CKD/scene axis.

    Replaces the reference's file-streaming aggregation
    (``src/SOS_AGGREGATE.F:372-459``): one einsum -> all-reduce over the
    scene axis of the mesh.
    """
    i3z = jnp.einsum("b,bscd->scd", weights, i3z_batch)
    emoins = jnp.sum(weights * emoins_batch)
    eplus = jnp.sum(weights * eplus_batch)
    return i3z, emoins, eplus


def aggregate_tau(weights, tau_batch):
    """Optical-depth aggregation in transmission space:
    tau = -ln(sum_i w_i exp(-tau_i)) (``src/SOS_AGGREGATE.F:466-488``)."""
    return -jnp.log(jnp.sum(weights * jnp.exp(-tau_batch)))


# ---------------------------------------------------------------------------
# CKD-term sharding of the production pipeline (used by proc.run)
# ---------------------------------------------------------------------------

def pad_terms(n_terms: int, n_shards: int) -> int:
    """Terms padded so the CKD batch divides the scene axis."""
    return ((n_terms + n_shards - 1) // n_shards) * n_shards


def pad_orders(n_s: int, n_shards: int) -> int:
    """Fourier orders padded so the S axis divides the fourier axis."""
    return ((n_s + n_shards - 1) // n_shards) * n_shards


def solve_terms_sharded(mesh: Mesh, inp: solver.SolveInputs,
                        opt: solver.SolveOptions):
    """``solver.solve_fourier_batch`` on a (scene[, fourier]) mesh.

    The CKD-term axis shards over ``scene`` (the embarrassingly parallel
    axis of SURVEY §2); when the mesh also carries a ``fourier`` axis of
    size > 1, the Fourier-order axis of the kernels (and surface matrices)
    shards over it — the orders are independent (``src/SOS_OS.F:872``), so
    each device solves its (local-terms x local-orders) block and only the
    tiny boundary records are gathered.  The absolute order index enters
    each shard through the sharded ``is0`` vector; the IS = 0 diffuse
    fluxes (``src/SOS_OS.F:1447-1456``) are ``psum``-reduced over the
    fourier axis so every shard returns the same per-term values.

    The term count must divide the scene axis (pad with AIK-weight-0
    duplicates via :func:`pad_terms`); orders are zero-padded here to
    divide the fourier axis (zero kernels converge immediately and the
    extra records are zeros, dropped by the caller's stop mask).
    """
    n_scene = mesh.shape["scene"]
    n_fourier = mesh.shape.get("fourier", 1)
    if inp.h.shape[0] % n_scene:
        raise ValueError(
            f"term count {inp.h.shape[0]} must divide scene axis {n_scene}")

    n_s = inp.k_aer.shape[0]
    n_sp = pad_orders(n_s, n_fourier)

    def pad_s(x):
        if x is None or n_sp == n_s:
            return x
        pad = [(0, n_sp - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, pad)

    if inp.is0 is not None:
        # caller dispatches a sub-range of absolute orders (blocked driver)
        is0 = pad_s(inp.is0.astype(inp.h.dtype))
    else:
        is0 = jnp.zeros((n_sp,), dtype=inp.h.dtype).at[0].set(1.0)
    inp = inp._replace(
        k_aer=pad_s(inp.k_aer), k_mol=pad_s(inp.k_mol),
        surface=inp.surface._replace(
            rmat=pad_s(inp.surface.rmat),
            rmat_sun=pad_s(inp.surface.rmat_sun)),
        is0=is0)

    n0 = inp.n0
    flags = (inp.surface.rmat is None, inp.surface.f11 is None,
             inp.surface.f12 is None, inp.surface.f33 is None,
             inp.surface.ind_surf is None, inp.zprof is None,
             inp.zout_km is None, jnp.ndim(inp.tab) == 1,
             inp.n0_col is None, inp.surface.rmat_sun is None)
    fn = _sharded_solver(mesh, opt, n0, flags, n_fourier > 1)
    res = fn(inp._replace(n0=None))
    if n_sp != n_s:   # drop the zero-padded orders
        res = res._replace(i3z=res.i3z[:, :n_s], i3bnd=res.i3bnd[:, :n_s])
    return res


def solve_terms_sharded_blocked(mesh: Mesh, inp: solver.SolveInputs,
                                opt: solver.SolveOptions, block=None):
    """Blocked Fourier dispatch composed with the scene-sharded term solve.

    When the mesh has no fourier axis (or size 1), the sequential Fourier
    early exit (``SOS_ARRET_FOURIER``) composes cleanly with scene
    sharding: each order block is one sharded term-solve, the stop test
    runs on the gathered (tiny) boundary records, and converged batches
    skip the remaining order blocks exactly like the single-chip driver.

    When the fourier axis is sharded (> 1), the orders are solved in
    PARALLEL across devices — a sequential early exit would serialize the
    axis it exists to parallelize, so the all-orders sharded solve is used
    and later orders are zeroed by the caller's post-hoc stop mask instead
    (same results; the "wasted" orders ride otherwise-idle devices).
    """
    if mesh.shape.get("fourier", 1) > 1:
        return solve_terms_sharded(mesh, inp, opt)
    return solver.solve_fourier_blocked(
        inp, opt, block=block,
        solve_fn=lambda i, o: solve_terms_sharded(mesh, i, o))


def solve_multiband_sharded(mesh: Mesh, inp: solver.SolveInputs,
                            opt: solver.SolveOptions):
    """Multiband solve with the CASE axis sharded over ``scene``.

    A LUT sweep's cases (leading axis of kernels/profiles/surface —
    ``solver.solve_fourier_multiband``) are embarrassingly parallel, so
    each device solves its local slice of cases and no collective runs at
    all (the per-case AIK aggregation happens on the host after the
    gather of the tiny boundary records).  The case count must divide the
    scene axis; pad with a duplicate case and drop it.

    Bands x AOT x albedo x geometry cases shard across devices and hosts,
    each solving its own (term x order) grid with the single-device
    kernels.
    """
    n_scene = mesh.shape["scene"]
    if inp.k_aer.shape[0] % n_scene:
        raise ValueError(f"case count {inp.k_aer.shape[0]} must divide "
                         f"scene axis {n_scene}")
    n0 = inp.n0
    flags = (inp.surface.rmat is None, inp.surface.f11 is None,
             inp.surface.f12 is None, inp.surface.f33 is None,
             inp.surface.ind_surf is None, inp.zprof is None,
             inp.zout_km is None, inp.n0_col is None,
             inp.surface.rmat_sun is None)
    fn = _sharded_multiband_solver(mesh, opt, n0, flags)
    return fn(inp._replace(n0=None))


@_functools.lru_cache(maxsize=None)
def _sharded_multiband_solver(mesh, opt, n0, flags):
    (no_rmat, no_f11, no_f12, no_f33, no_ind, no_zprof, no_zout,
     no_n0col, no_rmat_sun) = flags
    from jax.sharding import PartitionSpec as P

    case = P("scene")            # every per-case array shards on axis 0
    case_n = P("scene", None)
    rep = P()

    surf_specs = solver.SurfaceInputs(
        rho=case,
        rmat=None if no_rmat else case_n,
        f11=None if no_f11 else case_n,
        f12=None if no_f12 else case_n,
        f33=None if no_f33 else case_n,
        ind_surf=None if no_ind else case,
        rmat_sun=None if no_rmat_sun else case_n)
    in_specs = solver.SolveInputs(
        h=case_n, xdel=case_n, ydel=case_n,
        k_aer=case_n, k_mol=case_n, mu_pos=rep, w_pos=rep,
        tab=case, n0=None, surface=surf_specs,
        zprof=None if no_zprof else case_n,
        zout_km=None if no_zout else case,
        is0=None,                # all-orders multiband on this path
        n0_col=None if no_n0col else case_n)
    out_specs = solver.FourierResult(
        i3z=case_n, i3bnd=case_n, emoins=case_n, eplus=case_n,
        tauout=case_n, ig_last=case_n, stop_code=case_n)

    def local(local_inp):
        return solver.solve_fourier_multiband(
            local_inp._replace(n0=n0), opt)

    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(in_specs,),
                                 out_specs=out_specs, check_vma=False))


@_functools.lru_cache(maxsize=None)
def _sharded_solver(mesh, opt, n0, flags, shard_fourier):
    """Jitted shard_map solver, cached on (mesh, options, input structure)."""
    (no_rmat, no_f11, no_f12, no_f33, no_ind, no_zprof, no_zout,
     tab_batched, no_n0col, no_rmat_sun) = flags
    from jax.sharding import PartitionSpec as P

    four = "fourier" if shard_fourier else None
    term = P("scene")
    term_l = P("scene", None)
    term_s = P("scene", four)    # (T, S, ...) outputs
    rep = P()
    k_spec = P(four)             # (S, 3, 3, D, D) kernels

    surf_specs = solver.SurfaceInputs(
        rho=rep,
        rmat=None if no_rmat else k_spec,
        f11=None if no_f11 else rep,
        f12=None if no_f12 else rep,
        f33=None if no_f33 else rep,
        ind_surf=None if no_ind else rep,
        rmat_sun=None if no_rmat_sun else k_spec)
    in_specs = solver.SolveInputs(
        h=term_l, xdel=term_l, ydel=term_l,
        k_aer=k_spec, k_mol=k_spec, mu_pos=rep, w_pos=rep,
        tab=term if tab_batched else rep,
        n0=None, surface=surf_specs,
        zprof=None if no_zprof else term_l,
        zout_km=None if no_zout else rep,
        is0=k_spec,
        n0_col=None if no_n0col else term)
    out_specs = solver.FourierResult(
        i3z=term_s, i3bnd=term_s, emoins=term, eplus=term, tauout=term,
        ig_last=term_s, stop_code=term_s)

    def local(local_inp):
        res = solver.solve_fourier_batch(local_inp._replace(n0=n0), opt)
        if shard_fourier:
            # only the shard holding the absolute order 0 computed real
            # IS = 0 fluxes; zero the others and reduce so every shard
            # carries the same per-term values
            has0 = local_inp.is0[0]                  # 1.0 on the 0-shard
            res = res._replace(
                emoins=jax.lax.psum(res.emoins * has0, "fourier"),
                eplus=jax.lax.psum(res.eplus * has0, "fourier"))
            if not no_zout:
                nf = float(mesh.shape["fourier"])
                res = res._replace(
                    tauout=jax.lax.psum(res.tauout, "fourier") / nf)
        return res

    return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(in_specs,),
                                 out_specs=out_specs, check_vma=False))
