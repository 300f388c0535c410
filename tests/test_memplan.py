"""Memory-aware dispatch planner arithmetic.

A dispatch whose (orders x terms) tile exceeds device memory dies at XLA
buffer assignment while a CPU suite stays green.  These tests pin the
planner's estimate at a 16 GiB device and guarantee it can never hand the
dispatcher a shape that exceeds the budget.
"""

import numpy as np
import pytest

from radiativetransfer_sos_tpu import memplan

HBM16 = 16 * 2 ** 30
DEMO = dict(nt=600, n_mu=41)


def test_estimate_rejects_known_oom_shape():
    # 32 orders x 256 terms at the demo shape needs ~33 GB
    est = memplan.estimate_bytes(32, 256, **DEMO)
    assert est > memplan.budget_bytes(HBM16)


@pytest.mark.parametrize("block,chunk", [(16, 128), (8, 256), (4, 512)])
def test_estimate_accepts_known_good_shapes(block, chunk):
    # ~8 GB each at the demo shape
    est = memplan.estimate_bytes(block, chunk, **DEMO)
    assert est <= memplan.budget_bytes(HBM16)


def test_block_for_terms_boundaries():
    assert memplan.block_for_terms(512) == 4
    assert memplan.block_for_terms(256) == 4
    assert memplan.block_for_terms(128) == 8
    assert memplan.block_for_terms(64) == 8
    assert memplan.block_for_terms(16) == 16
    assert memplan.block_for_terms(1) == 16


@pytest.mark.parametrize("n_terms", [1, 5, 16, 100, 512, 3000, 5 ** 8])
@pytest.mark.parametrize("use_zout,imat", [(False, False), (True, True)])
def test_pick_always_fits_budget(n_terms, use_zout, imat):
    """Every reachable term count (up to the reference's Pi NEXP <= 5^8,
    inc/SOS.h:278-292) must yield a dispatch inside the budget."""
    block, chunk = memplan.pick_dispatch(n_terms, 81, 600, 41,
                                         use_zout=use_zout, imat_surf=imat,
                                         hbm=HBM16)
    assert 1 <= block <= 81
    assert 1 <= chunk <= max(n_terms, memplan.CHUNK_CANDIDATES[-1])
    est = memplan.estimate_bytes(block, chunk, 600, 41, use_zout, imat)
    assert est <= memplan.budget_bytes(HBM16)


def test_pick_uses_whole_batch_when_it_fits():
    block, chunk = memplan.pick_dispatch(512, 81, 600, 41, hbm=HBM16)
    assert (block, chunk) == (4, 512)
    # small batches: single chunk, measured block 16
    block, chunk = memplan.pick_dispatch(16, 81, 600, 41, hbm=HBM16)
    assert (block, chunk) == (16, 16)


def test_pick_respects_zout_overhead():
    """use_zout carries the level-resolved accumulator: the same term
    count must get a smaller dispatch."""
    hbm = 9.1e9   # budget admits (4, 512) plain (~8.2 GB) but not + zout
    plain = memplan.pick_dispatch(1024, 81, 600, 41, hbm=hbm)
    zout = memplan.pick_dispatch(1024, 81, 600, 41, use_zout=True,
                                 imat_surf=True, hbm=hbm)
    assert zout[0] * zout[1] < plain[0] * plain[1]


class _Dev:
    def __init__(self, platform, stats=None):
        self.platform = platform
        self.device_kind = "test " + platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_device_hbm_gpu_reads_bytes_limit():
    dev = _Dev("gpu", {"bytes_limit": 12345678, "bytes_in_use": 0})
    assert memplan.device_hbm(dev) == 12345678.0


def test_device_hbm_cpu_is_host_memory():
    import os
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert memplan.device_hbm(_Dev("cpu")) == float(host)
    import jax
    assert memplan.device_hbm(jax.devices("cpu")[0]) == float(host)


def test_device_hbm_unknown_device_raises():
    with pytest.raises(ValueError, match="no memory rule"):
        memplan.device_hbm(_Dev("rocm", {"bytes_limit": 1}))


def test_solver_defaults_route_through_planner():
    """solve_fourier_blocked_chunked with no explicit (block, chunk) must
    agree with the all-orders solve (picker-driven path)."""
    import jax.numpy as jnp

    from radiativetransfer_sos_tpu import precision, solver

    prob = precision.demo_problem(jnp.float64, n_gauss=8, nt=40, os_nb=24,
                                  igmax=15, n_terms=5)
    full = solver.solve_fourier_batch_jit(prob.inp, prob.opt)
    auto = solver.solve_fourier_blocked_chunked(prob.inp, prob.opt)

    def masked(res):
        recs = []
        for k in range(5):
            m = np.asarray(
                solver.fourier_stop_mask(np.asarray(res.i3bnd)[k]))
            recs.append(m[:, None, None] * np.asarray(res.i3bnd)[k])
        return np.stack(recs)

    np.testing.assert_allclose(masked(auto), masked(full), rtol=1e-12,
                               atol=1e-300)
