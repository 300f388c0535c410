"""End-to-end orchestrator: the SOS_PROC pipeline as one function.

Re-design of ``SOS_PROC`` (``src/SOS_PROC.F:415``).  The reference chains
property generators through files and runs the CKD exponential product as
an 8-deep sequential loop of full solver runs, aggregated by streaming
file rewrites (``SOS_AGGREGATE``, ``src/SOS_AGGREGATE.F:172``).  Here:

* every property is an in-memory array (angles, aerosol expansion,
  surface Fourier matrices, CKD tau profiles);
* the CKD term product is ONE batch axis — all per-term tau profiles are
  built up front, padded to a common layer count, and the jitted solver is
  ``vmap``-ed over the batch; the AIK aggregation is a weighted
  contraction, not a file rewrite (C18 -> einsum, SURVEY.md §2);
* CKD mode 2 collapses the batch before the solve
  (``src/SOS_PROC.F:3609-3725``).

The heavy compute (Fourier x scattering-order x layer sweep) runs inside
``solver.solve_fourier`` under jit; everything here is setup-path float64
NumPy per SURVEY.md §7.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import angles as angles_mod
from . import constants as cte
from . import gsf, kernels, profile, recompose, solver
from .absorption import gas_columns, load_ckd, tau_abs_all_terms
from .aerosols import (AerosolExpansion, decompose_legendre,
                       integrate_granulometry, mix_phase_matrices)
from .config import UNSET, UNSET_I, SosConfig
from .mie import run_mie_sweep_cached as run_mie_sweep
from .surface import bpdf_matrices, glitter_matrices, roujean_matrices
from .surface.fresnel import flat_sea_fresnel


# ---------------------------------------------------------------------------
# Rayleigh optical thickness
# ---------------------------------------------------------------------------

import functools as _functools


@_functools.lru_cache(maxsize=8)
def _gsf_basis_cached(mu_bytes: bytes, n: int, mus: float, os_nb: int,
                      n_s: int):
    """GSF basis memo: identical for every case of a same-geometry LUT
    sweep (the recurrence over L <= OS_NB x directions costs ~0.5 s/case
    on the 2-core host and dominated the batched sweep's prepare time)."""
    mu = np.frombuffer(mu_bytes, dtype=np.float64).reshape(n)
    return gsf.gsf_basis(mu, mus, os_nb, n_s)


@_functools.lru_cache(maxsize=16)
def _kernels_cached(mu_bytes: bytes, n: int, mus: float, os_nb: int,
                    n_s: int, alpha_b: bytes, beta_b: bytes,
                    gamma_b: bytes, zeta_b: bytes, mdf: float,
                    ipolar: bool):
    """Phase-operator memo: across a LUT sweep the (grid, expansion)
    pair repeats — AOT only scales the profile, not the normalized
    Legendre/GSF coefficients, so every AOT/albedo/geometry-output case
    of one aerosol model shares these (S, 3, 3, D, D) tensors."""
    psl, rsl, tsl = _gsf_basis_cached(mu_bytes, n, mus, os_nb, n_s)
    psl, rsl, tsl = map(jnp.asarray, (psl, rsl, tsl))
    coef = [np.frombuffer(b, dtype=np.float64)
            for b in (alpha_b, beta_b, gamma_b, zeta_b)]
    k_aer = kernels.aerosol_kernel(psl, rsl, tsl, *coef, ipolar)
    k_mol = kernels.molecular_kernel(psl, rsl, tsl, mdf, ipolar)
    return k_aer, k_mol


def _load_ckd_cached(nu: float, resolution: int, allow_missing: bool):
    """CKD table memo: one ASCII parse per (file window, resolution) per
    process.  Keyed on the FILE bounds, not the wavenumber — one CKD file
    covers 50 resolution steps (``src/SOS_SUB_TRS.F:655-660``), so a
    1 cm^-1 spectral sweep hits tens of wavenumbers per file and would
    otherwise re-parse the same multi-MB ASCII per wavelength."""
    from .absorption.ckd import ckd_file_bounds
    numax_f, numin_f = ckd_file_bounds(nu, resolution)
    return _load_ckd_window(numax_f, numin_f, resolution, allow_missing)


@_functools.lru_cache(maxsize=8)
def _load_ckd_window(numax_f, numin_f, resolution, allow_missing):
    return load_ckd(numax_f - 0.5 * resolution, resolution,
                    allow_missing=allow_missing)


@_functools.lru_cache(maxsize=16)
def _tau_terms_cached(nu, resolution, allow_missing, lamb, absprofil,
                      psurf, h2o, o3, co2, ch4):
    tables = _load_ckd_cached(nu, resolution, allow_missing)
    cols = gas_columns(absprofil, user_profile=None, psurf=psurf, h2o=h2o,
                       o3=o3, co2=co2, ch4=ch4)
    tau_terms, aik = tau_abs_all_terms(tables, lamb, cols)
    tau_terms.setflags(write=False)     # shared across cases
    aik.setflags(write=False)
    return tau_terms, aik, cols


def rayleigh_mot(wavelength: float, psurf: float) -> float:
    """Perbos (1982) CNES molecular optical thickness
    (``src/SOS_PROC.F:3333-3335``)."""
    wa = wavelength
    return (psurf / cte.HT_STD_PSURF) * 1.0e-4 * (
        84.35 / wa ** 4 - 1.225 / wa ** 5 + 1.4 / wa ** 6)


# ---------------------------------------------------------------------------
# Aerosol properties per configuration
# ---------------------------------------------------------------------------

def _signed_mu(grid):
    return np.concatenate([-grid.mu[::-1], [0.0], grid.mu])


def _phase_matrix_mono(mm, mie_grid, wavelength, at_ref: bool):
    mr = mm.mr_waref if at_ref and mm.mr_waref != UNSET else mm.mr_wa
    mi = mm.mi_waref if at_ref and mm.mi_waref != UNSET else mm.mi_wa
    if mm.sdtype == 1:
        igranu, v1, v2, v3 = 1, mm.lnd_radius, mm.lnd_var, 0.0
        alpha_max = 2.0 * np.pi * mm.lnd_radius * np.exp(
            4.0 * mm.lnd_var ** 2 + np.sqrt(
                2.0 * mm.lnd_var ** 2 * np.log(1.0 / cte.COEF_NRMAX))) \
            / wavelength
        alpha_max = min(alpha_max, cte.ALPHAMAX_WMO_DL)
    else:
        # VARGRANU1 = JD_RMIN (Junge plateau radius, src/SOS_PROC.F:1697)
        igranu, v1, v2, v3 = 2, mm.junge_rmin, mm.junge_slope, mm.junge_rmax
        alpha_max = 2.0 * np.pi * mm.junge_rmax / wavelength
    mie = run_mie_sweep(_signed_mu(mie_grid), mr, mi, cte.MIE_ALPHAMIN,
                        float(alpha_max))
    return integrate_granulometry(mie, igranu, v1, v2, v3, wavelength)


def _phase_matrix_bimodal(bmd, mie_grid, wavelength, at_ref: bool):
    def one(rmodal, var, mr, mi):
        alpha_max = 2.0 * np.pi * rmodal * np.exp(
            4.0 * var ** 2 + np.sqrt(
                2.0 * var ** 2 * np.log(1.0 / cte.COEF_NRMAX))) / wavelength
        alpha_max = min(alpha_max, cte.ALPHAMAX_WMO_DL)
        mie = run_mie_sweep(_signed_mu(mie_grid), mr, mi, cte.MIE_ALPHAMIN,
                            float(alpha_max))
        return integrate_granulometry(mie, 1, rmodal, var, 0.0, wavelength)

    if at_ref:
        fm = one(bmd.fm_rmodal, bmd.fm_var,
                 bmd.fm_mr_waref if bmd.fm_mr_waref != UNSET else bmd.fm_mr_wa,
                 bmd.fm_mi_waref if bmd.fm_mi_waref != UNSET else bmd.fm_mi_wa)
        cm = one(bmd.cm_rmodal, bmd.cm_var,
                 bmd.cm_mr_waref if bmd.cm_mr_waref != UNSET else bmd.cm_mr_wa,
                 bmd.cm_mi_waref if bmd.cm_mi_waref != UNSET else bmd.cm_mi_wa)
    else:
        fm = one(bmd.fm_rmodal, bmd.fm_var, bmd.fm_mr_wa, bmd.fm_mi_wa)
        cm = one(bmd.cm_rmodal, bmd.cm_var, bmd.cm_mr_wa, bmd.cm_mi_wa)

    # volume concentrations -> number fractions: N = Cv / (4/3 pi rm^3
    # exp(4.5 var^2)) for a log-normal (``src/SOS_AEROSOLS.F:2438-2475``)
    def n_of_cv(cv, rmodal, var):
        return cv / (4.0 / 3.0 * np.pi * rmodal ** 3
                     * np.exp(4.5 * var * var))

    if bmd.mode_param == 1:
        nf = np.array([n_of_cv(bmd.cv_coarse, bmd.cm_rmodal, bmd.cm_var),
                       n_of_cv(bmd.cv_fine, bmd.fm_rmodal, bmd.fm_var)])
    else:
        # tau-ratio parameterization at waref: solve the number fractions
        # that give AOTfine/AOTtot = rtau (``src/SOS_AEROSOLS.F:2560-2640``)
        r = bmd.rtau_fine_waref
        nf = np.array([(1.0 - r) / cm.sigma_ext, r / fm.sigma_ext])
    return mix_phase_matrices([cm, fm], nf)


_AER_PROPS_MEMO: dict = {}


def aerosol_properties(cfg: SosConfig, mie_grid):
    """(AerosolExpansion, TA at the simulation wavelength).

    Runs the property generator at the simulation wavelength, and a second
    time at the AOT reference wavelength when it differs — the simulated
    AOT is rescaled by the extinction ratio
    (``src/SOS_PROC.F:3028-3063``).

    Memoized in-process on every generating parameter (the granulometry
    integration + GSF projection repeat identically across the cases of a
    geometry/surface LUT sweep; user files participate via mtime+size).
    """
    import dataclasses as _dc
    import json as _json
    import os

    def _stamp(path):
        try:
            st = os.stat(path)
            return (path, st.st_mtime_ns, st.st_size)
        except (OSError, TypeError):
            return (path,)

    # an external phase function (IMOD=4) with no AOT reference rescale
    # is wavelength-INDEPENDENT — a 1 cm^-1 spectral sweep then reuses
    # one expansion instead of recomputing per wavelength
    wl_free = (cfg.aerosols.model == 4
               and (cfg.aerosols.waref == UNSET
                    or abs(cfg.aerosols.waref - cfg.wavelength) < 1e-9))
    key = (_json.dumps(_dc.asdict(cfg.aerosols), sort_keys=True,
                       default=str),
           0.0 if wl_free else float(cfg.wavelength),
           cfg.angles.nbmu_mie, cfg.angles.nbmu_lum,
           np.ascontiguousarray(mie_grid.mu).tobytes(),
           _stamp(cfg.aerosols.external_file),
           _stamp(getattr(cfg.aerosols, "mixture_file", None)))
    hit = _AER_PROPS_MEMO.get(key)
    if hit is not None:
        return hit
    out = _aerosol_properties_impl(cfg, mie_grid)
    for f in _dc.fields(out[0]):
        v = getattr(out[0], f.name)
        if isinstance(v, np.ndarray):
            v.setflags(write=False)         # shared across cases
    if len(_AER_PROPS_MEMO) > 32:
        _AER_PROPS_MEMO.pop(next(iter(_AER_PROPS_MEMO)))
    _AER_PROPS_MEMO[key] = out
    return out


def _aerosol_properties_impl(cfg: SosConfig, mie_grid):
    aer = cfg.aerosols
    os_nb, _, _ = angles_mod.expansion_orders(cfg.angles.nbmu_mie,
                                              cfg.angles.nbmu_lum)
    if aer.aot_ref <= 0.0 or aer.model == UNSET_I:
        z = np.zeros(os_nb + 1)
        exp = AerosolExpansion(alpha=z, beta=z, gamma=z, zeta=z,
                               coef_tronca=0.0, piz=1.0, piz_tronc=1.0,
                               sigma_ext=0.0, sigma_sca=0.0)
        return exp, 0.0

    if aer.model == 0:
        pm_sim = _phase_matrix_mono(aer.mm, mie_grid, cfg.wavelength, False)
        pm_ref_fn = lambda: _phase_matrix_mono(aer.mm, mie_grid,
                                               aer.waref, True)
    elif aer.model == 1:
        from .aerosol_models import wmo_phase_matrix
        user_v = None
        if aer.wmo_model == 4:
            user_v = np.array([aer.wmo_dl, aer.wmo_ws, aer.wmo_oc,
                               aer.wmo_so])
        cap = getattr(aer, "alpha_cap", None)
        pm_sim = wmo_phase_matrix(_signed_mu(mie_grid), cfg.wavelength,
                                  aer.wmo_model, user_v, alpha_cap=cap)
        pm_ref_fn = lambda: wmo_phase_matrix(_signed_mu(mie_grid), aer.waref,
                                             aer.wmo_model, user_v,
                                             alpha_cap=cap)
    elif aer.model == 2:
        from .aerosol_models import sf_phase_matrix
        cap = getattr(aer, "alpha_cap", None)
        pm_sim = sf_phase_matrix(_signed_mu(mie_grid), cfg.wavelength,
                                 aer.sf_model, aer.sf_rh, alpha_cap=cap)
        pm_ref_fn = lambda: sf_phase_matrix(_signed_mu(mie_grid), aer.waref,
                                            aer.sf_model, aer.sf_rh,
                                            alpha_cap=cap)
    elif aer.model == 3:
        pm_sim = _phase_matrix_bimodal(aer.bmd, mie_grid, cfg.wavelength,
                                       False)
        pm_ref_fn = lambda: _phase_matrix_bimodal(aer.bmd, mie_grid,
                                                  aer.waref, True)
    elif aer.model == 4:
        from .external_aerosols import external_phase_matrix
        if abs(aer.waref - cfg.wavelength) > 1.0e-9 and aer.waref != UNSET:
            raise ValueError("external phase functions require "
                             "waref == wavelength (src/SOS_ABS_MAIN.F:677)")
        pm_sim = external_phase_matrix(aer.external_file, mie_grid)
        pm_ref_fn = lambda: pm_sim
    elif aer.model == 5:
        from .external_aerosols import (mixture_phase_matrices,
                                        parse_mixture_file)
        modes = parse_mixture_file(aer.mixture_file)
        waref = aer.waref if aer.waref != UNSET else cfg.wavelength
        pm_sim, _pm_ref = mixture_phase_matrices(
            _signed_mu(mie_grid), cfg.wavelength, waref, aer.aot_ref,
            modes, alpha_cap=getattr(aer, "alpha_cap", None))
        pm_ref_fn = lambda: _pm_ref
    else:
        raise NotImplementedError(
            f"aerosol model {aer.model} not implemented "
            "(0 mono, 1 WMO, 2 S&F, 3 bimodal, 4 external, 5 mixture)")

    if aer.waref != UNSET and abs(aer.waref - cfg.wavelength) > 1.0e-9:
        pm_ref = pm_ref_fn()
        ta = aer.aot_ref * pm_sim.sigma_ext / pm_ref.sigma_ext
    else:
        ta = aer.aot_ref

    expn = decompose_legendre(pm_sim, mie_grid.mu, mie_grid.w, os_nb,
                              aer.tronca)
    return expn, float(ta)


# ---------------------------------------------------------------------------
# Surface matrices per ISURF
# ---------------------------------------------------------------------------

def surface_matrices(cfg: SosConfig, grid
                     ) -> tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """The Fourier reflection-matrix product of ``SOS_SURFACE``
    (``src/SOS_SURFACE.F:341``): ``(rmat, rmat_sun)``, both None when
    ISURF has no matrix.

    With the solar angle injected into the grid (reference parity,
    ``grid.imus >= 0``) the matrices cover the grid pairs and
    ``rmat_sun`` is None — the solver gathers the solar column at
    ``n0``.  In decoupled mode (``angles.solar_in_grid = False``) the
    pair set is extended by the solar angle as a weight-0 slot — exactly
    how the reference's injected slot participates
    (``src/SOS_ANGLES.F:370-466``) — and the solar incidence row is
    returned apart as ``rmat_sun`` (S, 3, N) while ``rmat`` keeps the
    sun-independent (N, N) block.

    Memoized through the product cache with every generating parameter in
    the key — the array equivalent of the reference's parameter-encoded
    surface file names (``SOS_NOM_FIC_SURFACE.F:114-1049``, existence check
    ``src/SOS_SURFACE.F:585-603``).
    """
    s = cfg.surface
    os_nb, os_ns, os_nm = angles_mod.expansion_orders(cfg.angles.nbmu_mie,
                                                      cfg.angles.nbmu_lum)
    if s.type not in (1, 3, 4, 5, 6, 7):
        return None, None

    decoupled = getattr(grid, "imus", 0) < 0
    if decoupled:
        xmus = float(np.cos(np.radians(grid.thetas_deg)))
        mu = np.concatenate([np.asarray(grid.mu), [xmus]])
        w = np.concatenate([np.asarray(grid.w), [0.0]])
    else:
        mu, w = grid.mu, grid.w

    def compute():
        if s.type == 1:
            rmat = glitter_matrices(mu, w, s.wind, s.ind,
                                    os_nb, os_ns, os_nm)
        elif s.type == 3:
            rmat = roujean_matrices(mu, s.k0, s.k1, s.k2, os_nb)
        else:
            model = {4: "rondeaux", 5: "breon", 6: "nadal",
                     7: "maignan"}[s.type]
            rmat = bpdf_matrices(model, mu, w, s.ind, os_nb,
                                 os_ns, os_nm, k0=s.k0, k1=s.k1, k2=s.k2,
                                 alpha=s.alpha_nadal, beta=s.beta_nadal,
                                 coef_c=s.coef_c_maignan)
        return {"rmat": np.asarray(rmat)}

    from .cache import memo
    params = dict(isurf=s.type, mu=np.asarray(mu), wind=s.wind,
                  ind=s.ind, k0=s.k0, k1=s.k1, k2=s.k2,
                  alpha=s.alpha_nadal, beta=s.beta_nadal,
                  coef_c=s.coef_c_maignan, os_nb=os_nb, os_ns=os_ns,
                  os_nm=os_nm)
    rmat = memo("surf", params, compute)["rmat"]
    if not decoupled:
        return rmat, None
    n = grid.mu.shape[0]
    # rmat[s, so, si, incident, outgoing]: solar incidence row, unpolarized
    # direct beam (si = 0) -> the n0 column of src/SOS_OS.F:970-992
    return rmat[..., :n, :n], np.ascontiguousarray(rmat[:, :, 0, n, :n])


# ---------------------------------------------------------------------------
# Truncation adjustment of a discretized profile (src/SOS.F:511-543)
# ---------------------------------------------------------------------------

def truncation_adjust(h, pcaer, pcmol, piz, piz_tronc, coef_tronca):
    """tau-profile rescale for the truncated phase function + conversion of
    the aerosol extinction fraction into a scattering fraction.

    Batched: the level axis is the LAST axis; any leading axes (e.g. the
    CKD term batch) broadcast — a per-term Python loop here cost ~0.1 s
    per 2000 terms of a spectral sweep (r5 profile)."""
    h = np.asarray(h, dtype=np.float64).copy()
    xdel = np.asarray(pcaer, dtype=np.float64).copy()
    ydel = np.asarray(pcmol, dtype=np.float64).copy()
    a = coef_tronca
    if a != 0.0:
        dh = np.diff(h, axis=-1)
        va = xdel[..., 1:] * dh
        vatr = va * (1.0 - piz * 0.5 * a)
        vr = ydel[..., 1:] * dh
        vg = (1.0 - xdel[..., 1:] - ydel[..., 1:]) * dh
        tot = vatr + vr + vg
        htr = np.concatenate(
            [h[..., :1], h[..., :1] + np.cumsum(tot, axis=-1)], axis=-1)
        with np.errstate(invalid="ignore", divide="ignore"):
            xdel = np.concatenate(
                [xdel[..., :1], np.where(tot > 0, vatr / tot, 0.0)],
                axis=-1)
            ydel = np.concatenate(
                [ydel[..., :1], np.where(tot > 0, vr / tot, 0.0)],
                axis=-1)
        h = htr
    xdel = xdel * piz_tronc
    return h, xdel, ydel


# ---------------------------------------------------------------------------
# Results container + the pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SosResults:
    """Aggregated outputs of one run (the SOS_PROC intent(out) set,
    ``binding/run_sos.py:636-695``)."""
    grid: angles_mod.RadianceGrid
    records_up: np.ndarray       # (S, 3, D) aggregated Fourier Stokes, ZOUT up
    records_down: np.ndarray     # same values (signed axis holds both
    #   hemispheres, ``src/SOS_OS.F:1571-1575``) but an independent array:
    #   consumers may mutate one view without corrupting the other
    ttot_tronc: float            # truncated total optical depth
    ttot_vrai: float             # true total optical depth
    tauout: float                # optical depth of the output level
    emoins: float                # downward diffuse flux
    eplus: float                 # upward diffuse flux
    coef_tronca: float
    n_ckd_terms: int
    thetas_deg: float = 0.0
    # diffuse transmittances of the equivalent (truncated) atmosphere
    # (filled when cfg.compute_transmissions; ``src/SOS.F:605-637``)
    tdifmus: Optional[float] = None       # TOA -> ground, solar incidence
    tdifmug: Optional[np.ndarray] = None  # (N,) ground -> TOA per Gauss angle
    # per-stage wall times from the tracer (SURVEY.md §5)
    timings: Optional[dict] = None
    # view tables (filled by trphi_option)
    phi: Optional[np.ndarray] = None
    theta: Optional[np.ndarray] = None
    up: Optional[dict] = None
    down: Optional[dict] = None

    # -- derived flux outputs (``src/SOS_PROC.F:3828-3837``) ---------------
    @property
    def _mus(self) -> float:
        return float(np.cos(np.radians(self.thetas_deg)))

    @property
    def flux_dir_down(self) -> float:
        """Direct downward transmission for the TRUE optical depth."""
        return float(np.exp(-self.ttot_vrai / self._mus))

    @property
    def flux_diff_down(self) -> float:
        """EMOINS + Tdir_tronc - Tdir_vrai."""
        return float(self.emoins + np.exp(-self.ttot_tronc / self._mus)
                     - np.exp(-self.ttot_vrai / self._mus))

    @property
    def flux_tot_down(self) -> float:
        return float(self.emoins + np.exp(-self.ttot_tronc / self._mus))

    @property
    def flux_diff_up(self) -> float:
        return float(self.eplus)

    def trans_down(self) -> float:
        """Total diffuse transmittance TOA -> surface at solar incidence:
        td = TDIFMUS + Tdir_tronc - Tdir_vrai (``src/SOS_PROC.F:3791-3803``)."""
        return float(self.tdifmus + np.exp(-self.ttot_tronc / self._mus)
                     - np.exp(-self.ttot_vrai / self._mus))

    def trans_up(self) -> np.ndarray:
        """Diffuse transmittance surface -> TOA per Gauss angle (reciprocity,
        ``src/SOS_PROC.F:3808-3816``)."""
        mu = self.grid.mu
        return (self.tdifmug + np.exp(-self.ttot_tronc / mu)
                - np.exp(-self.ttot_vrai / mu))


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("opt",))
def _solve_vmapped(inp_batch: solver.SolveInputs, opt: solver.SolveOptions):
    """Jitted term-batched solve over the explicit (order x term) grid
    (see solve_fourier_batch)."""
    return solver.solve_fourier_batch(inp_batch, opt)


def _solve_batch(inp_batch: solver.SolveInputs, opt: solver.SolveOptions,
                 n_terms: int):
    """Jitted term-batched solve; results carry the (T, ...) axis."""
    return _solve_vmapped(inp_batch, opt)


@_partial(jax.jit, static_argnames=("opt",))
def _solve_trans_batch(inp_batch: solver.SolveInputs,
                       opt: solver.SolveOptions):
    """Black-surface IS=0 solves batched over (CKD term x incidence).

    The reference runs SOS_OS once per incidence direction per CKD term
    with RHO=0, no surface matrices, IBORM=0 (``src/SOS.F:605-637``); the
    diffuse transmittance is the EMOINS of each run.  Here (term,
    incidence) is the flattened batch axis of ``solve_fourier_batch``
    (per-item ``tab``).
    """
    return solver.solve_fourier_batch(inp_batch, opt).emoins


def _transmissions(lum, hs, xds, yds, k_aer, k_mol, aik, igmax, ipolar):
    """(tdifmus, tdifmug): AIK-aggregated diffuse transmittances.

    One extra batched solve replaces the reference's 1 + NBMU sequential
    SOS_OS runs per CKD term (SURVEY.md §3.4).
    """
    n_terms = hs.shape[0]
    n = lum.mu.shape[0]
    mus_all = np.concatenate([[lum.mus], -lum.mu])   # solar + Gauss (tab < 0)
    n_dir = mus_all.shape[0]
    # primary-source kernel column per incidence: the solar center slot,
    # then each Gauss direction's downward signed slot (the reference's
    # reciprocity runs call SOS_OS with N0 = J, src/SOS.F:622-635, so the
    # primary scattering couples through THAT direction's kernel column)
    n0_cols = np.concatenate([[n], n - 1 - np.arange(n)])

    hb = jnp.asarray(np.repeat(hs, n_dir, axis=0))
    xb = jnp.asarray(np.repeat(xds, n_dir, axis=0))
    yb = jnp.asarray(np.repeat(yds, n_dir, axis=0))
    tabb = jnp.asarray(np.tile(mus_all, n_terms))

    inp = solver.SolveInputs(
        h=hb, xdel=xb, ydel=yb, k_aer=k_aer[:1], k_mol=k_mol[:1],
        mu_pos=jnp.asarray(lum.mu), w_pos=jnp.asarray(lum.w),
        tab=tabb, n0=0,
        n0_col=jnp.asarray(np.tile(n0_cols, n_terms)),
        surface=solver.SurfaceInputs(rho=jnp.asarray(0.0)))
    opt = solver.SolveOptions(igmax=igmax, ipolar=ipolar)
    emoins = np.asarray(_solve_trans_batch(inp, opt)).reshape(n_terms, n_dir)
    tdif = aik @ emoins                              # linear in AIK (C18)
    return float(tdif[0]), tdif[1:]


def run(cfg: SosConfig, trace=None, mesh=None) -> SosResults:
    """The full pipeline: properties -> batched CKD solve -> aggregation.

    ``trace``: optional :class:`tracing.Trace` collecting per-stage timers
    and events (the reference's -*.Log narration, SURVEY.md §5).
    ``mesh``: optional :class:`jax.sharding.Mesh` with a ``scene`` axis —
    the CKD-term batch is sharded over it (terms padded with AIK-weight-0
    duplicates to divide the axis) and the AIK aggregation reduces across
    devices; see ``parallel.solve_terms_sharded``.
    """
    if trace is None:
        from .tracing import NullTrace
        trace = NullTrace()
    cfg.validate()

    # SURVEY §5 profiling subsystem: RTSOS_PROFILE=<dir> wraps the whole
    # pipeline in a JAX/XLA profiler trace (viewable in TensorBoard /
    # Perfetto) on top of the per-stage wall timers below
    import contextlib
    import os as _os

    prof_dir = _os.environ.get("RTSOS_PROFILE")

    @contextlib.contextmanager
    def _profiled():
        import jax.profiler as _prof
        try:
            _prof.start_trace(prof_dir)
            started = True
        except Exception as e:  # profiler unavailable — degrade, don't die
            started = False
            trace.event("profile", error=str(e)[:120])
        try:
            yield
        finally:
            if started:
                try:
                    _prof.stop_trace()
                except Exception as e:
                    trace.event("profile", error=str(e)[:120])

    ctx = _profiled() if prof_dir else contextlib.nullcontext()
    with ctx:
        return _run_traced(cfg, trace, mesh)


def _run_traced(cfg: SosConfig, trace, mesh) -> SosResults:
    prep = prepare_case(cfg, trace, mesh)
    res = dispatch_case(prep, trace, mesh)
    return finish_case(prep, res, trace)


@dataclasses.dataclass
class PreparedCase:
    """Everything between property generation and the device solve.

    ``prepare_case`` -> ``dispatch_case`` -> ``finish_case`` is exactly
    ``run`` split at the solve boundary, so a LUT driver can prepare many
    cases on the host and solve them in ONE multiband dispatch
    (``lut.sos_run_many(batch_cases=...)``,
    ``solver.solve_fourier_multiband``).
    """
    cfg: SosConfig
    lum: object
    inp: solver.SolveInputs
    opt: solver.SolveOptions
    aik: np.ndarray
    n_terms: int
    n_solved: int
    iborm: int
    aer_exp: object
    ttot_vrai_terms: np.ndarray
    ttot_tronc_terms: np.ndarray
    use_zout: bool
    hs: np.ndarray
    xds: np.ndarray
    yds: np.ndarray
    k_aer: object
    k_mol: object
    io: dict
    # content keys of the case's kernels and surface matrices (every
    # generating parameter; albedo excluded — it enters the solve as a
    # broadcastable scalar).  Cases of a LUT sweep that share BOTH can
    # flatten into one term axis and solve at single-case dispatch speed
    # (lut._run_batched: the vmapped multiband path measures ~2x slower
    # per instance than the flat (S, T) grid, r5)
    kernel_key: tuple = ()
    surf_key: tuple = ()


def prepare_case(cfg: SosConfig, trace=None, mesh=None) -> PreparedCase:
    """Host-side pipeline of one case: properties -> SolveInputs."""
    if trace is None:
        from .tracing import NullTrace
        trace = NullTrace()
    from .cache import enable_compile_cache
    enable_compile_cache()           # idempotent; ~50 s of a cold run
    cfg.validate()

    # --- angle grids (C4)
    with trace.stage("angles"):
        lum = angles_mod.make_radiance_grid(
            cfg.angles.thetas_deg, cfg.angles.nbmu_lum,
            cfg.angles.user_rad_deg,
            inject_solar=cfg.angles.solar_in_grid)
        mie_grid = angles_mod.make_mie_grid(cfg.angles.nbmu_mie,
                                            cfg.angles.user_mie_deg)
        os_nb, os_ns, os_nm = angles_mod.expansion_orders(
            cfg.angles.nbmu_mie, cfg.angles.nbmu_lum)

    io = getattr(cfg, "io", {})
    if io:
        from . import products
    if "-ANG.Rad.ResFile" in io:
        products.write_angles_file(
            io["-ANG.Rad.ResFile"], lum.mu, lum.w, "LUM", os_nb,
            cfg.angles.nbmu_lum, thetas_deg=cfg.angles.thetas_deg,
            imus=lum.imus, os_ns=os_ns, os_nm=os_nm,
            is_user=lum.is_user)
    if "-ANG.Aer.ResFile" in io:
        products.write_angles_file(
            io["-ANG.Aer.ResFile"], mie_grid.mu, mie_grid.w, "MIE",
            os_nb, cfg.angles.nbmu_mie)
    if "-ANG.Log" in io:
        products.write_ang_log(io["-ANG.Log"], lum, mie_grid, os_nb,
                               os_ns, os_nm, cfg.angles.thetas_deg)

    # --- molecular optical thickness
    tr = cfg.profile.mot
    if tr == UNSET:
        tr = rayleigh_mot(cfg.wavelength, cfg.profile.psurf)

    # --- aerosols (C5/C6)
    from . import mie as mie_mod
    if "-AER.MieLog" in io:
        mie_mod.SWEEP_LOG = []
    try:
        with trace.stage("aerosols"):
            if "-AER.UserFile" in io and cfg.aerosols.aot_ref > 0.0:
                # consume a precomputed aerosol-expansion file instead of
                # running the aerosol chain (src/SOS_PROC.F:2883-2933); no
                # waref rescaling in this mode ("pas le cas si utilisation
                # d'un fichier utilisateur", src/SOS_PROC.F:3028)
                data = products.read_aerosols_file(io["-AER.UserFile"])
                for key in ("alpha", "beta", "gamma", "zeta"):
                    c = data[key]
                    if c.shape[0] < os_nb + 1:
                        c = np.pad(c, (0, os_nb + 1 - c.shape[0]))
                    data[key] = c[: os_nb + 1]
                aer_exp = AerosolExpansion(**data)
                ta = float(cfg.aerosols.aot_ref)
                trace.event("aerosols", userfile=io["-AER.UserFile"])
            else:
                aer_exp, ta = aerosol_properties(cfg, mie_grid)
        if "-AER.MieLog" in io:
            products.write_mie_log(io["-AER.MieLog"], mie_mod.SWEEP_LOG)
    finally:
        mie_mod.SWEEP_LOG = None
    trace.event("aerosols", ta=round(ta, 6),
                coef_tronca=round(aer_exp.coef_tronca, 6))
    if "-AER.ResFile" in io:
        products.write_aerosols_file(io["-AER.ResFile"], aer_exp)
    if "-AER.Log" in io:
        products.write_aer_log(io["-AER.Log"], aer_exp, ta)

    # --- surface (C7-C11)
    with trace.stage("surface"):
        import os as _os
        surf_file = io.get("-SURF.File")
        rmat_sun = None
        if surf_file and _os.path.exists(surf_file) and lum.imus >= 0:
            # explicit surface-matrix file named by the user: read it back
            # instead of recomputing (the reference's existence check,
            # src/SOS_SURFACE.F:585-603).  Decoupled-sun grids bypass the
            # file (it cannot carry the separate solar column) and rely on
            # the product cache instead.
            rmat = products.read_surface_bin(surf_file, lum.mu.shape[0])
        else:
            rmat, rmat_sun = surface_matrices(cfg, lum)
            if surf_file and rmat is not None and lum.imus >= 0:
                products.write_surface_bin(surf_file, rmat)
    if "-SURF.Log" in io:
        s_ = cfg.surface
        products.write_surf_log(
            io["-SURF.Log"], s_.type,
            {k: getattr(s_, k) for k in ("alb", "ind", "wind", "k0", "k1",
                                         "k2", "alpha_nadal", "beta_nadal",
                                         "coef_c_maignan")
             if getattr(s_, k) != UNSET}, rmat)
    isurf = cfg.surface.type
    igli = isurf == 1
    ifresnel = isurf == 2
    imat_surf = rmat is not None

    # --- absorption (C12-C14): tau_abs per CKD term
    use_abs = (cfg.absorption.absprofil != 7) and (cfg.profile.type == 1)
    trace_abs = trace.stage("absorption"); trace_abs.__enter__()
    if use_abs:
        nu = 1.0e4 / cfg.wavelength
        tables = _load_ckd_cached(nu, cfg.absorption.resolution,
                                  bool(cfg.absorption.allow_missing_gas))
        if tables.missing:
            trace.event("ckd", missing_gases=list(tables.missing))
        lamb = tables.band_index(nu)
        o3 = cfg.absorption.o3
        a = cfg.absorption
        # per-term tau_abs depends only on (band, atmosphere, gas
        # contents); every aerosol/surface/geometry case of a sweep
        # shares it (no user-profile caching: mutable array argument)
        if a.user_profile is None:
            tau_terms, aik, cols = _tau_terms_cached(
                nu, a.resolution, bool(a.allow_missing_gas), lamb,
                a.absprofil, float(cfg.profile.psurf), a.h2o,
                o3 / 1000.0 if o3 != UNSET else UNSET, a.co2, a.ch4)
        else:
            cols = gas_columns(a.absprofil, user_profile=a.user_profile,
                               psurf=cfg.profile.psurf, h2o=a.h2o,
                               o3=o3 / 1000.0 if o3 != UNSET else UNSET,
                               co2=a.co2, ch4=a.ch4)
            tau_terms, aik = tau_abs_all_terms(tables, lamb, cols)
        if cfg.absorption.mode_ckd == 2:
            trs = (aik[:, None] * np.exp(-tau_terms)).sum(axis=0)
            tau_terms = np.maximum(-np.log(trs), 0.0)[None, :]
            aik = np.ones(1)
        altabs = cols.alt_desc
    else:
        tau_terms = np.zeros((1, cte.ABS_NBLEV))
        aik = np.ones(1)
        altabs = None

    trace_abs.__exit__(None, None, None)
    n_terms = tau_terms.shape[0]
    trace.event("ckd", n_terms=n_terms)

    # --- per-term profiles (C15) + truncation adjustment (C16)
    from . import native
    trace_prof = trace.stage("profiles"); trace_prof.__enter__()

    def _quantize(nt_max):
        # quantize the static layer count to the solver's level quantum
        # (NT+1 a multiple of solver.LEVEL_QUANTUM): spectral-sweep cases
        # then share one solve shape — one executable, one multiband
        # group — instead of one per adaptive layer count, and the solver
        # pads nothing more.  The bottom-replicated pad rows are
        # zero-thickness, exact no-ops for the sweep (Profile.padded)
        return solver.pad_levels(nt_max) - 1

    raw = None
    if cfg.profile.type == 2:
        profs = [profile.slab_profile(tr, cfg.profile.hr, ta,
                                      cfg.profile.zmin, cfg.profile.zmax)
                 for _ in range(n_terms)]
    elif use_abs and native.available():
        # one native call builds every term's adaptive grid, consumed as
        # raw arrays (per-term Profile objects + Python pad/truncation
        # loops cost ~0.6 s per 2000 terms of a spectral sweep, r5)
        raw = native.exp_profiles_batch_arrays(
            tr, cfg.profile.hr, ta, cfg.profile.ha, altabs, tau_terms)
    else:
        profs = []
        for k in range(n_terms):
            if use_abs and tau_terms[k, -1] > 0.0:
                p = profile.exp_profile_with_gas(tr, cfg.profile.hr, ta,
                                                 cfg.profile.ha, altabs,
                                                 tau_terms[k])
            else:
                p = profile.exp_profile_no_gas(tr, cfg.profile.hr, ta,
                                               cfg.profile.ha)
            profs.append(p)

    if raw is not None:
        z_r, h_r, pca_r, pcm_r, nts = raw
        nt_max = _quantize(int(nts.max()))
        rows = np.arange(nts.shape[0])[:, None]
        # bottom-replicated static-shape padding == Profile.padded
        idx = np.minimum(np.arange(nt_max + 1)[None, :], nts[:, None])
        ttot_vrai_terms = h_r[rows[:, 0], nts]
        hs, xds, yds = truncation_adjust(
            h_r[rows, idx], pca_r[rows, idx], pcm_r[rows, idx],
            aer_exp.piz, aer_exp.piz_tronc, aer_exp.coef_tronca)
        zprofs = z_r[rows, idx]
    else:
        nt_max = _quantize(max(p.nt for p in profs))
        ttot_vrai_terms = np.array([p.h[-1] for p in profs])
        padded = [p.padded(nt_max) for p in profs]
        hs, xds, yds = truncation_adjust(
            np.stack([pp.h for pp in padded]),
            np.stack([pp.pcaer for pp in padded]),
            np.stack([pp.pcmol for pp in padded]),
            aer_exp.piz, aer_exp.piz_tronc, aer_exp.coef_tronca)
        zprofs = np.stack([pp.zprof for pp in padded])
    ttot_tronc_terms = hs[:, -1]
    trace_prof.__exit__(None, None, None)
    if "-AP.Log" in io:
        products.write_ap_log(io["-AP.Log"], hs, xds, yds, zprofs,
                              ttot_vrai_terms)

    # --- Fourier order cap: pure Rayleigh cuts at IS <= 2 (src/SOS.F:546-550)
    pure_rayleigh = bool(np.all(xds == 0.0))
    iborm = 2 if pure_rayleigh else os_nb

    # --- kernels (C17 inputs)
    def _b(a):
        return np.ascontiguousarray(a, dtype=np.float64).tobytes()

    kernel_args = (
        _b(lum.mu), lum.mu.shape[0], float(lum.mus), os_nb, iborm + 1,
        _b(aer_exp.alpha), _b(aer_exp.beta), _b(aer_exp.gamma),
        _b(aer_exp.zeta), float(cfg.mdf), bool(cfg.ipolar))
    k_aer, k_mol = _kernels_cached(*kernel_args)
    # every parameter the surface matrices / Fresnel vectors derive from
    # (albedo excluded: it broadcasts per term in the flattened solve)
    _s = cfg.surface
    surf_key = (_s.type, _s.ind, _s.wind, _s.k0, _s.k1, _s.k2,
                _s.alpha_nadal, _s.beta_nadal, _s.coef_c_maignan,
                _b(lum.mu), lum.imus, float(lum.thetas_deg),
                io.get("-SURF.File"))

    if ifresnel or igli:
        f11, f12, f33 = flat_sea_fresnel(lum.mu, lum.mus, cfg.surface.ind,
                                         cfg.ipolar)
    else:
        f11 = f12 = f33 = np.zeros(lum.n + 1)

    surf = solver.SurfaceInputs(
        rho=jnp.asarray(float(cfg.surface.alb)),
        rmat=None if rmat is None else jnp.asarray(rmat[: iborm + 1]),
        f11=jnp.asarray(f11), f12=jnp.asarray(f12), f33=jnp.asarray(f33),
        ind_surf=jnp.asarray(float(cfg.surface.ind)
                             if cfg.surface.ind != UNSET else 1.34),
        rmat_sun=(None if rmat_sun is None
                  else jnp.asarray(rmat_sun[: iborm + 1])))
    use_zout = cfg.view.zout_km != UNSET
    opt = solver.SolveOptions(igmax=cfg.igmax, imat_surf=imat_surf,
                              ifresnel=ifresnel, ipolar=cfg.ipolar,
                              use_zout=use_zout)

    n_solved = n_terms
    if mesh is not None:
        # pad the term batch with weight-0 duplicates so it divides the
        # scene axis; the padded solves are discarded by the aggregation
        from .parallel import pad_terms
        n_solved = pad_terms(n_terms, mesh.shape["scene"])
    if n_solved != n_terms:
        pad = n_solved - n_terms
        hs = np.concatenate([hs, np.repeat(hs[:1], pad, axis=0)])
        xds = np.concatenate([xds, np.repeat(xds[:1], pad, axis=0)])
        yds = np.concatenate([yds, np.repeat(yds[:1], pad, axis=0)])
        zprofs = np.concatenate([zprofs,
                                 np.repeat(zprofs[:1], pad, axis=0)])

    inp = solver.SolveInputs(
        h=jnp.asarray(hs), xdel=jnp.asarray(xds), ydel=jnp.asarray(yds),
        k_aer=k_aer, k_mol=k_mol, mu_pos=jnp.asarray(lum.mu),
        w_pos=jnp.asarray(lum.w), tab=jnp.asarray(lum.mus),
        n0=max(lum.imus, 0),     # -1 = decoupled sun: n0 unused (rmat_sun)
        surface=surf,
        zprof=jnp.asarray(zprofs) if use_zout else None,
        zout_km=jnp.asarray(float(cfg.view.zout_km)) if use_zout else None)
    return PreparedCase(
        cfg=cfg, lum=lum, inp=inp, opt=opt, aik=aik, n_terms=n_terms,
        n_solved=n_solved, iborm=iborm, aer_exp=aer_exp,
        ttot_vrai_terms=ttot_vrai_terms,
        ttot_tronc_terms=ttot_tronc_terms, use_zout=use_zout,
        hs=hs, xds=xds, yds=yds, k_aer=k_aer, k_mol=k_mol, io=io,
        kernel_key=kernel_args, surf_key=surf_key)


def dispatch_case(prep: PreparedCase, trace=None,
                  mesh=None) -> solver.FourierResult:
    """Device solve of one prepared case (the routing run() always took);
    results are trimmed back to the case's true term count."""
    if trace is None:
        from .tracing import NullTrace
        trace = NullTrace()
    inp, opt = prep.inp, prep.opt
    n_terms, n_solved, iborm = prep.n_terms, prep.n_solved, prep.iborm
    with trace.stage("solve"):
        if mesh is not None:
            # scene-sharded terms; blocked Fourier early exit composes when
            # the fourier axis is unsharded (solve_terms_sharded_blocked
            # docstring for the sharded-fourier rationale)
            from .parallel import solve_terms_sharded_blocked
            res = solve_terms_sharded_blocked(mesh, inp, opt)
        elif iborm + 1 > 24 and n_terms * (iborm + 1) >= 1024:
            # block dispatch with the reference's sequential Fourier early
            # exit (SOS_ARRET_FOURIER) — skips orders the post-hoc mask
            # would zero anyway.  Only pays off once the (terms x orders)
            # batch is large enough to keep the chip busy per block;
            # small batches are dispatch-latency-bound and the all-orders
            # batch wins.  (block, term_chunk) come from the memory-aware
            # planner (memplan.pick_dispatch) so no term count can route
            # into a shape that fails to compile; measured numbers live
            # in memplan.BLOCK_BY_TERMS and BENCH output, not here
            res = solver.solve_fourier_blocked_chunked(inp, opt)
        else:
            res = _solve_batch(inp, opt, n_terms)
        res = jax.tree_util.tree_map(
            lambda x: x.block_until_ready() if hasattr(
                x, "block_until_ready") else x, res)
        if n_solved != n_terms:   # drop the padded terms
            res = jax.tree_util.tree_map(lambda x: x[:n_terms], res)

    _narrate_convergence(prep, res, trace)
    return res


def _narrate_convergence(prep: PreparedCase, res, trace) -> None:
    """Per-IS/IG convergence narration (the reference's unit-99 OS log,
    src/SOS_OS.F:1306-1415; SURVEY §5 "debug dumps of scan carry")."""
    if res.ig_last is None:
        return
    io = prep.io
    if io:
        from . import products
    ig = np.asarray(res.ig_last)
    code = np.asarray(res.stop_code)
    names = {0: "igmax", 1: "geom-conv", 2: "valdif", 3: "sumdif"}
    trace.event("scattering", ig_mean=round(float(ig.mean()), 2),
                ig_max=int(ig.max()),
                stops={names[c]: int((code == c).sum())
                       for c in np.unique(code)})
    for t in range(min(prep.n_terms, 4)):    # per-order dump, first terms
        trace.event(
            "scattering.orders", term=t,
            ig_per_order=[int(v) for v in ig[t]],
            stop_per_order=[names[int(c)] for c in code[t]])
    if "-SOS.Log" in io:
        products.write_sos_log(io["-SOS.Log"], ig, code,
                               np.asarray(res.emoins),
                               np.asarray(res.eplus))


# jitted once per shape: the eager jax.vmap used before re-traced the
# stop test on EVERY finished case (~30 ms/case on the 2-core host —
# a third of a LUT sweep's output path, profiled r5)
_stop_mask_cpu_jit = jax.jit(jax.vmap(solver.fourier_stop_mask))


def _aggregate_records(aik, i3z, i3bnd):
    """Device-side C18: Fourier stop mask + AIK-weighted contraction of
    the per-term records (``src/SOS_AGGREGATE.F:372-441``), so only the
    reduced (S, 3, D) table crosses the device->host link.  HIGHEST
    precision keeps the f32 contraction out of bf16."""
    mask = jax.vmap(solver.fourier_stop_mask)(i3bnd)
    return jnp.einsum("t,ts,tscd->scd", aik, mask.astype(i3z.dtype), i3z,
                      precision=jax.lax.Precision.HIGHEST)


_aggregate_records_jit = jax.jit(_aggregate_records)
#: per-case aggregation of a whole multiband group in one dispatch
#: (padded terms carry AIK weight 0)
_aggregate_multiband_jit = jax.jit(jax.vmap(_aggregate_records))


@jax.jit
def _aggregate_cases_jit(w, i3z, i3bnd):
    """Per-case aggregation of a FLATTENED term axis (lut flatten path):
    ``w`` (C, T_flat) carries each case's AIK weights in its own slice
    (zeros elsewhere, including padded duplicate terms)."""
    mask = jax.vmap(solver.fourier_stop_mask)(i3bnd)
    return jnp.einsum("kt,ts,tscd->kscd", w, mask.astype(i3z.dtype), i3z,
                      precision=jax.lax.Precision.HIGHEST)


def finish_case(prep: PreparedCase, res, trace=None,
                recs: Optional[np.ndarray] = None) -> SosResults:
    """Aggregation + transmissions of one solved case (run()'s tail).

    ``recs``: pre-aggregated (S, 3, D) records — the batched LUT driver
    aggregates a whole multiband group on the device in one dispatch
    (:data:`_aggregate_multiband_jit`) and passes each case's slice here;
    ``res`` then only needs the small per-term scalar fields."""
    if trace is None:
        from .tracing import NullTrace
        trace = NullTrace()
    cfg, lum, aik = prep.cfg, prep.lum, prep.aik
    n_terms, use_zout = prep.n_terms, prep.use_zout
    ttot_vrai_terms = prep.ttot_vrai_terms
    ttot_tronc_terms = prep.ttot_tronc_terms
    hs, xds, yds = prep.hs, prep.xds, prep.yds
    k_aer, k_mol = prep.k_aer, prep.k_mol
    aer_exp = prep.aer_exp

    # --- aggregation (C18): AIK-weighted contraction over the batch axis.
    # One vmapped stop-mask call for the whole term batch: at a real 1 cm^-1
    # CKD product (hundreds-thousands of terms) a per-term host loop here
    # would put thousands of dispatches on the output path.  Two routes:
    #
    # * SMALL batches (LUT sweeps of 1-10-term bands, or host arrays from
    #   the multiband group transfer): records come to the host and the
    #   tiny mask runs on the CPU backend, which saves a device round trip
    #   per finished case on a batched sweep's output path.
    # * LARGE device-resident batches (the production 1 cm^-1 case,
    #   hundreds+ terms): the mask + weighted contraction run ON the
    #   device and ONE transfer fetches the reduced (S, 3, D) records
    #   plus the per-term scalars instead of the full (T, S, 3, D)
    #   records.
    trace_agg = trace.stage("aggregate"); trace_agg.__enter__()
    on_device = (recs is None and not isinstance(res.i3z, np.ndarray)
                 and getattr(res.i3z, "nbytes", 0) > 2_000_000)
    if recs is not None:
        recs = np.asarray(recs, dtype=np.float64)
        emoins_t, eplus_t = np.asarray(res.emoins), np.asarray(res.eplus)
        tauout_t = np.asarray(res.tauout) if use_zout else None
    elif on_device:
        recs_d = _aggregate_records_jit(
            jnp.asarray(aik, dtype=res.i3z.dtype), res.i3z, res.i3bnd)
        recs, emoins_t, eplus_t, tauout_t = jax.device_get(
            (recs_d, res.emoins, res.eplus,
             res.tauout if use_zout else res.emoins))
        recs = np.asarray(recs, dtype=np.float64)
    else:
        i3z = np.asarray(res.i3z)               # (terms, S, 3, D)
        i3bnd_h = np.asarray(res.i3bnd)
        with jax.default_device(jax.devices("cpu")[0]):
            mask = np.asarray(_stop_mask_cpu_jit(jnp.asarray(i3bnd_h)))
        recs = np.einsum("t,ts,tscd->scd", aik,
                         mask.astype(np.float64), i3z)
        emoins_t, eplus_t = np.asarray(res.emoins), np.asarray(res.eplus)
        tauout_t = np.asarray(res.tauout) if use_zout else None
    emoins = float(aik @ np.asarray(emoins_t, dtype=np.float64
                                    ).reshape(n_terms))
    eplus = float(aik @ np.asarray(eplus_t, dtype=np.float64
                                   ).reshape(n_terms))
    # optical depths aggregate in transmission space
    # (``src/SOS_AGGREGATE.F:466-488``)
    ttot_tronc = -np.log(np.sum(aik * np.exp(-ttot_tronc_terms)))
    ttot_vrai = -np.log(np.sum(aik * np.exp(-ttot_vrai_terms)))
    # tauout aggregates in transmission space like the total depths
    # (``src/SOS_AGGREGATE.F:466-488``)
    if use_zout:
        tauout_terms = np.asarray(tauout_t, dtype=np.float64
                                  ).reshape(n_terms)
        tauout = -np.log(np.sum(aik * np.exp(-tauout_terms)))
    else:
        tauout = 0.0
    trace_agg.__exit__(None, None, None)

    # --- diffuse transmittances (src/SOS.F:605-637, one batched solve)
    tdifmus = tdifmug = None
    if cfg.compute_transmissions:
        with trace.stage("transmissions"):
            tdifmus, tdifmug = _transmissions(lum, hs, xds, yds, k_aer,
                                              k_mol, aik, cfg.igmax,
                                              cfg.ipolar)

    return SosResults(grid=lum, records_up=recs, records_down=recs.copy(),
                      ttot_tronc=float(ttot_tronc),
                      ttot_vrai=float(ttot_vrai), tauout=tauout,
                      emoins=emoins, eplus=eplus,
                      coef_tronca=aer_exp.coef_tronca, n_ckd_terms=n_terms,
                      thetas_deg=cfg.angles.thetas_deg,
                      tdifmus=tdifmus, tdifmug=tdifmug)


# ---------------------------------------------------------------------------
# View recomposition (C19) on aggregated records
# ---------------------------------------------------------------------------

def trphi_option(cfg: SosConfig, res: SosResults) -> SosResults:
    """Fill the (phi x theta) output tables like ``SOS_TRPHI_OPTION``
    (``src/SOS_TRPHI.F:285``): view 1 = principal plane (rows phi+180,
    phi), view 2 = polar diagram (rows phi=0..360 step dphi)."""
    grid = res.grid
    s = cfg.surface
    terms = recompose.DirectTerms(
        igli=s.type == 1, ifresnel=s.type == 2, iroujean=s.type >= 3,
        irondeaux=s.type == 4, ibreon=s.type == 5, inadal=s.type == 6,
        imaignan=s.type == 7,
        wind=s.wind if s.wind != UNSET else 0.0,
        ind_surf=s.ind if s.ind != UNSET else 1.34,
        k0=s.k0 if s.k0 != UNSET else 0.0,
        k1=s.k1 if s.k1 != UNSET else 0.0,
        k2=s.k2 if s.k2 != UNSET else 0.0,
        alpha_nadal=s.alpha_nadal if s.alpha_nadal != UNSET else 0.0,
        beta_nadal=s.beta_nadal if s.beta_nadal != UNSET else 0.0,
        coef_c_maignan=s.coef_c_maignan if s.coef_c_maignan != UNSET
        else 0.0)

    if cfg.view.itrphi == 1:
        phis_deg = np.array([cfg.view.phi_deg + 180.0, cfg.view.phi_deg])
    else:
        phis_deg = np.arange(0.0, 360.0 + 1e-9, cfg.view.dphi_deg)

    n = grid.n
    phis = np.radians(phis_deg)
    # one recomposition matmul over every requested azimuth + one
    # broadcasted add-back pass (the reference loops SOS_TRPHI once per
    # azimuth -- 361 passes at Dphi = 1, src/SOS_TRPHI.F:431-615)
    f = recompose.recompose_np(res.records_up, phis)
    xit, xqt, xut = recompose.add_direct_terms(
        f[:, 0], f[:, 1], f[:, 2], grid.mu, grid.imus, grid.mus,
        res.ttot_tronc, res.tauout, phis, terms, cfg.ipolar)

    out, dn = {}, {}
    ups = slice(n + 1, 2 * n + 1)
    # downward directions of the signed axis are stored mirrored
    for tabs, sl, flip in ((out, ups, False), (dn, slice(0, n), True)):
        xi = xit[:, sl][:, ::-1] if flip else xit[:, sl]
        xq = xqt[:, sl][:, ::-1] if flip else xqt[:, sl]
        xu = xut[:, sl][:, ::-1] if flip else xut[:, sl]
        ang, rate, lpol = recompose.polar_params(xi, xq, xu)
        tabs.update(i=xi, q=xq, u=xu, pol_ang=ang, pol_rate=rate,
                    l_pol=lpol)
    sca = recompose.scattering_angles(
        np.concatenate([-grid.mu, grid.mu]), grid.mus, phis[:, None])
    out["sca"] = sca[:, n:]
    dn["sca"] = sca[:, :n]

    res.phi = phis_deg
    res.theta = grid.theta_deg
    res.up = out
    res.down = dn
    return res


def sos_run(cfg: SosConfig, trace=None, mesh=None) -> SosResults:
    """run + view recomposition in one call (the SOS_PROC surface).

    When the config carries a ``-SOS_Main.Log`` io entry and no tracer is
    passed, a file tracer is opened for the run and closed with the
    reference's JOB_STATUS trailer (``src/SOS_PROC.F:1508-1530``)."""
    own = False
    if trace is None:
        logfile = getattr(cfg, "io", {}).get("-SOS_Main.Log")
        if logfile:
            from .tracing import Trace
            trace = Trace(logfile=logfile)
            own = True
    try:
        res = run(cfg, trace, mesh=mesh)
        if trace is not None:
            with trace.stage("trphi"):
                res = trphi_option(cfg, res)
        else:
            res = trphi_option(cfg, res)
    except Exception:
        if own:
            trace.close(ok=False)
        raise
    if trace is not None:
        res.timings = dict(trace.timings)
    if own:
        trace.close(ok=True)
    return res
