"""The production solve path, compiled and run on a GPU.

Skipped without one (``gpu_device`` fixture); run on the card with
``python -m pytest -m gpu tests/``.  Same bodies as ``chip_smoke.py``
phase c (``checks.blocked_solve_check``):

- AOT-compile the blocked executable at the exact (block, term_chunk) the
  memory planner picks for a 512-term production batch, and hold the
  compiled executable's reported memory to the planner's estimate (an
  upper bound) and to the device's limit;
- run the blocked f32 solve end to end on the GPU (the compiled sweep
  kernel, not interpret mode) and gate it against the CPU f64 oracle at
  the production precision tolerances.
"""

import jax
import pytest

from radiativetransfer_sos_tpu import checks

pytestmark = pytest.mark.gpu


def test_gpu_chunked_defaults_compile_at_production_scale(gpu_device):
    with jax.enable_x64(False), jax.default_device(gpu_device):
        rec = checks.blocked_solve_check(n_terms=512)
    assert rec["xla_bytes"] <= rec["estimate_bytes"], rec
    assert rec["xla_bytes"] < rec["bytes_limit"], rec
    assert rec["ok"], rec


def test_gpu_blocked_solve_matches_cpu_f64(gpu_device):
    with jax.enable_x64(False), jax.default_device(gpu_device):
        rec = checks.blocked_solve_check(n_terms=16)
    assert rec["err"] <= rec["limit"], rec
    assert rec["ok"], rec
