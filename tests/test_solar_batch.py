"""Sun geometry as a batchable LUT axis (angles.solar_in_grid = False).

The reference injects the solar zenith angle into the radiance grid as a
weight-0 view direction (``src/SOS_ANGLES.F:370-466``), which makes every
theta_s a different grid and forces its LUT workload into one process per
geometry (``exe/runSOS-ABS_demo.ksh``).  The decoupled mode keeps the grid
sun-independent — the solar direction enters through the kernel center
slot (``src/SOS_OS.F:706-715``), ``tab`` and the surface solar column
(``src/SOS_OS.F:970-992``) — so a theta_s sweep shares one static grid
and one multiband dispatch.
"""

import numpy as np
import pytest

from radiativetransfer_sos_tpu import lut, proc
from radiativetransfer_sos_tpu.config import (AbsConfig, AngleConfig,
                                              AerosolConfig,
                                              MonoModalAerosol,
                                              ProfileConfig, SosConfig,
                                              SurfaceConfig)


def _cfg(thetas=35.0, solar_in_grid=True, surf_type=0, aot=0.0, alb=0.1):
    aer = AerosolConfig()
    prof = ProfileConfig(hr=8.0, ha=2.0)
    if aot > 0.0:
        aer = AerosolConfig(
            aot_ref=aot, waref=0.550, model=0,
            mm=MonoModalAerosol(sdtype=1, lnd_radius=0.2, lnd_var=0.4,
                                mr_wa=1.44, mi_wa=-0.0,
                                mr_waref=1.44, mi_waref=-0.0))
    surf = SurfaceConfig(type=surf_type, alb=alb)
    if surf_type == 1:
        surf = SurfaceConfig(type=1, alb=alb, ind=1.34, wind=2.0)
    return SosConfig(
        wavelength=0.550,
        angles=AngleConfig(nbmu_lum=10, nbmu_mie=12, thetas_deg=thetas,
                           solar_in_grid=solar_in_grid),
        aerosols=aer, surface=surf, profile=prof,
        absorption=AbsConfig(absprofil=7), igmax=30)


def _common(res_dec, res_inj):
    """Match the decoupled grid's view angles inside the injected grid."""
    td, ti = res_dec.theta, res_inj.theta
    idx = [int(np.argmin(np.abs(ti - t))) for t in td]
    assert np.allclose(ti[idx], td, atol=1e-10)
    return np.asarray(idx)


def test_decoupled_matches_injected_rayleigh():
    """Removing the weight-0 solar slot changes no physics: radiances at
    the shared view angles agree with the reference-parity grid."""
    r_inj = proc.sos_run(_cfg(solar_in_grid=True))
    r_dec = proc.sos_run(_cfg(solar_in_grid=False))
    idx = _common(r_dec, r_inj)
    np.testing.assert_allclose(r_dec.up["i"], r_inj.up["i"][:, idx],
                               rtol=1e-8)
    np.testing.assert_allclose(r_dec.up["q"], r_inj.up["q"][:, idx],
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(r_dec.emoins, r_inj.emoins, rtol=1e-10)


def test_decoupled_matches_injected_glitter():
    """The separate solar column (SurfaceInputs.rmat_sun) reproduces the
    injected grid's n0 gather for a Cox-Munk matrix surface."""
    r_inj = proc.sos_run(_cfg(solar_in_grid=True, surf_type=1, alb=0.0))
    r_dec = proc.sos_run(_cfg(solar_in_grid=False, surf_type=1, alb=0.0))
    idx = _common(r_dec, r_inj)
    np.testing.assert_allclose(r_dec.up["i"], r_inj.up["i"][:, idx],
                               rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(r_dec.up["q"], r_inj.up["q"][:, idx],
                               rtol=1e-4, atol=1e-10)


def test_flat_sea_requires_solar_slot():
    cfg = _cfg(solar_in_grid=False, surf_type=0)
    cfg.surface = SurfaceConfig(type=2, alb=0.0, ind=1.34)
    with pytest.raises(ValueError, match="2412"):
        cfg.validate()


def test_thetas_sweep_one_multiband_group():
    """A theta_s x AOT sweep shares ONE grid -> one multiband group, and
    the batched results are identical to the per-case path (VERDICT r4
    item 4 'done' criterion)."""
    base = _cfg(solar_in_grid=False, aot=0.2, alb=0.1)
    cases = lut.sweep_configs(base, {
        "angles.thetas_deg": [20.0, 35.0, 50.0],
        "aerosols.aot_ref": [0.1, 0.3],
    })

    # the sweep forms a single compatible group
    preps = [proc.prepare_case(c) for c in cases]
    import radiativetransfer_sos_tpu.lut as lut_mod

    def key(p):
        i = p.inp
        s = i.surface
        return (i.h.shape[1], p.iborm, i.n0, p.opt,
                np.asarray(i.mu_pos).tobytes(),
                np.asarray(i.w_pos).tobytes(),
                s.rmat is None, s.f11 is None, s.f12 is None,
                s.f33 is None, s.ind_surf is None, s.rmat_sun is None,
                p.use_zout, str(i.h.dtype))

    assert len({key(p) for p in preps}) == 1

    seq = lut.sos_run_many(cases)
    bat = lut.sos_run_many(cases, batch_cases=True)
    for rs, rb in zip(seq, bat):
        np.testing.assert_array_equal(rb.up["i"], rs.up["i"])
        np.testing.assert_array_equal(rb.up["q"], rs.up["q"])
        np.testing.assert_array_equal(rb.up["u"], rs.up["u"])
        np.testing.assert_array_equal(rb.records_up, rs.records_up)

    # physics sanity: the sun geometry observably differs per case (the
    # beam-normalized diffuse flux grows with the slant path), so the
    # per-case tab / solar kernel columns really vary inside the batch
    e = {c.angles.thetas_deg: r.emoins
         for c, r in zip(cases, seq) if c.aerosols.aot_ref == 0.1}
    assert e[20.0] < e[35.0] < e[50.0]


def test_thetas_sweep_glitter_one_group():
    """Same, through the rmat_sun surface path."""
    base = _cfg(solar_in_grid=False, surf_type=1, alb=0.0, aot=0.2)
    cases = lut.sweep_configs(base, {"angles.thetas_deg": [25.0, 45.0]})
    seq = lut.sos_run_many(cases)
    bat = lut.sos_run_many(cases, batch_cases=True)
    for rs, rb in zip(seq, bat):
        np.testing.assert_array_equal(rb.up["i"], rs.up["i"])
        np.testing.assert_array_equal(rb.up["q"], rs.up["q"])


@pytest.mark.gpu
def test_thetas_sweep_on_gpu(gpu_device):
    """The decoupled-sun multiband sweep and a flattened AOT x albedo sweep
    on the GPU: the f32 device path (sweep kernel + device-side group
    aggregation) agrees with the sequential per-case path within the
    device-aggregation tolerance.  Same body as ``chip_smoke.py`` phase e,
    at a smaller angle grid."""
    import jax

    from radiativetransfer_sos_tpu import checks

    with jax.enable_x64(False), jax.default_device(gpu_device):
        rec = checks.lut_check(nbmu=10, n_aot=2, n_alb=2,
                               thetas=(25.0, 45.0))
    assert rec["ok"], rec
