"""The layer-sweep kernel and the scattering-source matmul vs. their
plain references, on the CPU.

The sweep kernel (``sweep_triton.sweep``, a Pallas kernel on the Triton
route, reference ``SOS_INTEGR_EPOPT``, ``src/SOS_OS.F:2222-2354``) runs here
in interpret mode (``pl.pallas_call(..., interpret=True)``) against the
associative-scan sweep, so breaking the kernel's contract fails the CPU
suite; ``test_gpu_kernels_match_scan`` runs it compiled on a GPU.  The
scattering source (``solver._scatter_source``, reference
``SOS_FSOURCE_ORDREIG``, ``src/SOS_OS.F:2663``) is held to a float64 NumPy
evaluation written the other way round: ``x*(F@M_aer) + y*(F@M_mol)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radiativetransfer_sos_tpu import checks, solver, sweep_triton
from radiativetransfer_sos_tpu.solver import _sweep_flat_scan


def _case(nt, ts, hp, seed, zero_pad_layers=0):
    """Random sweep instance batch; optionally close with zero-thickness
    padding layers (dtau = 0) like the profile discretizer's static-NT pad."""
    rng = np.random.default_rng(seed)
    w = 2 * hp
    dh = rng.uniform(1e-4, 5e-2, size=(ts, nt)).astype(np.float32)
    if zero_pad_layers:
        dh[:, nt - zero_pad_layers:] = 0.0
    h = np.concatenate([np.zeros((ts, 1), np.float32), np.cumsum(dh, axis=1)],
                       axis=1)
    muh = np.concatenate([rng.uniform(0.05, 1.0, size=hp - 2),
                          np.ones(2)]).astype(np.float32)
    src = rng.standard_normal((ts, nt + 1, w)).astype(np.float32)
    bc = rng.standard_normal((ts, hp)).astype(np.float32)
    return jnp.asarray(h), jnp.asarray(muh), jnp.asarray(src), jnp.asarray(bc)


def _run_kernel(h, muh, src, bc):
    """Drive the kernel through the solver's level padding (identity layers
    up to ``solver.pad_levels``).  Returns the field trimmed back to
    (TS, NT+1, W)."""
    ts, ntp1, _ = src.shape
    lp = solver.pad_levels(ntp1 - 1)
    h_p = jnp.pad(h, ((0, 0), (0, lp - ntp1)), mode="edge")
    src_p = jnp.pad(src, ((0, 0), (0, lp - ntp1), (0, 0)))
    out = sweep_triton.sweep(h_p, muh, src_p, bc, interpret=True)
    return np.asarray(out[:, :ntp1])


def _f64_reference(h, muh, src, bc):
    """f64 associative-scan sweep — the accumulation-order-independent
    truth both f32 paths are judged against."""
    out = jax.vmap(_sweep_flat_scan, in_axes=(0, None, 0, 0))(
        jnp.asarray(h, jnp.float64), jnp.asarray(muh, jnp.float64),
        jnp.asarray(src, jnp.float64), jnp.asarray(bc, jnp.float64))
    return np.asarray(out)


def _assert_as_accurate(got, h, muh, src, bc):
    """The kernel (sequential level loop) and the f32 scan (log-depth tree)
    round differently, so compare both to the f64 truth: the kernel's
    worst error must be within a small factor of the f32 scan's own."""
    want = _f64_reference(h, muh, src, bc)
    scan32 = np.asarray(jax.vmap(_sweep_flat_scan, in_axes=(0, None, 0, 0))(
        h, muh, src, bc))
    err_got = np.max(np.abs(got - want))
    err_scan = np.max(np.abs(scan32 - want))
    assert err_got <= 4.0 * err_scan + 1e-6, (err_got, err_scan)


@pytest.mark.parametrize("nt,ts", [(1, 1), (7, 3), (255, 8), (600, 9)])
def test_sweep_interpret_matches_scan(nt, ts):
    h, muh, src, bc = _case(nt, ts, hp=16, seed=nt * 31 + ts)
    _assert_as_accurate(_run_kernel(h, muh, src, bc), h, muh, src, bc)


def test_sweep_interpret_zero_thickness_pad_layers():
    # trailing dtau == 0 layers must be identity steps (profile pads)
    h, muh, src, bc = _case(120, 5, hp=16, seed=7, zero_pad_layers=30)
    _assert_as_accurate(_run_kernel(h, muh, src, bc), h, muh, src, bc)


def test_sweep_choice_by_platform():
    """One place picks the sweep, by the platform it is lowered for: the
    GPU lowering carries the Triton kernel, the CPU lowering the scan."""
    h, muh, src, bc = _case(30, 2, hp=128, seed=5)
    src = jnp.concatenate([src, src])              # S = 2 orders x T = 2
    bc = jnp.concatenate([bc, bc])
    traced = jax.jit(solver._sweep_batched).trace(h, muh, src, bc)
    gpu = traced.lower(lowering_platforms=("cuda",)).as_text()
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    assert "sos_layer_sweep" in gpu and "triton" in gpu
    assert "sos_layer_sweep" not in cpu and "triton" not in cpu
    np.testing.assert_allclose(
        np.asarray(jax.jit(solver._sweep_batched)(h, muh, src, bc)),
        np.asarray(jax.jit(solver._sweep_scan_batched)(h, muh, src, bc)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("s_n,t_n,lp", [(2, 8, 128), (3, 16, 128),
                                        (8, 4, 640)])
def test_scatter_matches_f64_einsum(s_n, t_n, lp):
    """The scattering source at HP = 128 (the demo hemisphere width)
    against float64 NumPy: mixing applied after each operator."""
    hp = 128
    w = 2 * hp
    rng = np.random.default_rng(s_n * 7 + t_n)
    fld = rng.standard_normal((s_n, t_n, lp, w)).astype(np.float32)
    xd = rng.uniform(0.0, 1.0, (t_n, lp)).astype(np.float32)
    yd = (1.0 - xd).astype(np.float32)
    mboth = (0.05 * rng.standard_normal((s_n, 2 * w, w))).astype(np.float32)
    got = np.asarray(solver._scatter_source(
        jnp.asarray(fld), jnp.asarray(xd), jnp.asarray(yd),
        jnp.asarray(mboth)))
    f64 = fld.astype(np.float64)
    m_aer, m_mol = mboth[:, :w].astype(np.float64), \
        mboth[:, w:].astype(np.float64)
    want = (xd[None, :, :, None] * np.einsum("stlk,skj->stlj", f64, m_aer)
            + yd[None, :, :, None] * np.einsum("stlk,skj->stlj", f64,
                                                m_mol))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_gpu_kernels_match_scan(gpu_device):
    """The compiled (non-interpret) kernel on the GPU — interpret mode
    cannot catch Triton lowering or launch regressions.  Same body as
    ``chip_smoke.py`` phase a, at a smaller batch."""
    with jax.enable_x64(False), jax.default_device(gpu_device):
        rec = checks.sweep_check(n_orders=2, n_terms=16, nt=300, n_ref=16)
    assert rec["ok"], rec
