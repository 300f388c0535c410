"""Memory-aware planning of the (Fourier block x CKD term chunk) dispatch.

The production CKD loop solves up to Pi NEXP <= 5^8 exponential-tuple terms
(``inc/SOS.h:278-292``, loop ``src/SOS_PROC.F:3459-3594``).  The terms and
Fourier orders are batch axes of one compiled solve, so the dispatch size
is bounded by device memory, not by correctness: a (block x term_chunk)
tile that exceeds it dies at XLA buffer assignment.

This module owns the arithmetic that prevents that: a byte estimate of the
solve's persistent live set and a picker that walks a preference order and
returns the first (block, term_chunk) that fits the device.  ``proc.run``
and the chunked dispatch default to the picker, so no caller can route
into a shape that will not compile.
"""

import os
from typing import Optional, Tuple

#: headroom kept free of the plan: XLA's reserved arena, host-transfer
#: staging buffers and allocator slack
RESERVE_FRACTION = 0.05
RESERVE_BYTES = 0.3e9


def budget_bytes(hbm: float) -> float:
    return hbm * (1.0 - RESERVE_FRACTION) - RESERVE_BYTES

#: Fourier block size by dispatch term count, ``(min_terms, block)``.
#: Small blocks waste fewer orders past the SOS_ARRET_FOURIER stop; large
#: term batches amortize each dispatch.  An untuned rule: not yet swept on
#: the GPU.
BLOCK_BY_TERMS: Tuple[Tuple[int, int], ...] = ((256, 4), (64, 8), (0, 16))

#: term-chunk candidates, largest first — bigger chunks amortize the
#: per-block dispatch overhead
CHUNK_CANDIDATES: Tuple[int, ...] = (1024, 512, 256, 128, 64, 32)


def block_for_terms(n_terms: int) -> int:
    """Fourier block for a dispatch of ``n_terms`` terms."""
    for min_t, block in BLOCK_BY_TERMS:
        if n_terms >= min_t:
            return block
    return BLOCK_BY_TERMS[-1][1]


#: XLA's live set of one dispatch in field-sized (S, T, LP, HP) units: the
#: while-loop field carry, the scatter's mixed operand and source, the
#: sweep output and their copies.  BASE is the ratio
#: ``compiled.memory_analysis()`` reported on an NVIDIA H100 for the
#: planner-picked (4 orders, 512 terms) demo-shape executable (8.03,
#: ``chip_smoke.py`` phase c) with a 2% margin.  ``use_zout`` adds the
#: level-resolved accumulator and its previous order; zout + surface
#: matrices add the direct-reflection field: untuned rules, not measured
#: on the GPU.
FIELD_MULT_BASE = 8.2
FIELD_MULT_ZOUT = 6.2
FIELD_MULT_ZOUT_IMAT = 1.1


def estimate_bytes(block: int, term_chunk: int, nt: int, n_mu: int,
                   use_zout: bool = False, imat_surf: bool = False,
                   itemsize: int = 4) -> int:
    """Estimate of the peak live set of one blocked-chunked solve dispatch.

    The dominant buffers are the field-sized (S, T, LP, HP) tensors XLA
    keeps live across the scattering ``while_loop`` (``solver._solve_st``)
    plus their copies; the multiplier is calibrated, not derived
    (:data:`FIELD_MULT_BASE`).  On top: the per-order phase operators
    k_aer/k_mol and their flattened matmul form.

    Checked against the compiled executable's reported footprint on the
    device (``tests/test_gpu_production.py``; the estimate must stay an
    upper bound).
    """
    from .solver import _half_pad, pad_levels

    lp = pad_levels(nt)
    hp = _half_pad(n_mu)
    w = 2 * hp
    field = block * term_chunk * lp * hp * itemsize
    mult = FIELD_MULT_BASE + (FIELD_MULT_ZOUT if use_zout else 0.0) \
        + (FIELD_MULT_ZOUT_IMAT if (imat_surf and use_zout) else 0.0)
    d = 2 * n_mu + 1
    operators = 2 * block * 9 * d * d * itemsize     # k_aer + k_mol
    operators += block * (2 * w) * w * itemsize      # flattened mboth
    return int(mult * field) + operators


def device_hbm(device=None) -> float:
    """Memory (bytes) a solve may plan for on ``device``.

    A GPU reports what the runtime lets the process allocate
    (``memory_stats()["bytes_limit"]``); the CPU backend plans against the
    host's physical memory.  Any other device is an error: there is no
    default size to assume.
    """
    if device is None:
        import jax
        device = jax.devices()[0]
    if device.platform == "gpu":
        return float(device.memory_stats()["bytes_limit"])
    if device.platform == "cpu":
        return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))
    raise ValueError(f"no memory rule for a {device.platform!r} device "
                     f"({getattr(device, 'device_kind', '?')})")


def pick_dispatch(n_terms: int, n_orders: int, nt: int, n_mu: int,
                  use_zout: bool = False, imat_surf: bool = False,
                  hbm: Optional[float] = None,
                  device=None) -> Tuple[int, int]:
    """Fastest (block, term_chunk) that fits the device memory budget.

    Walks :data:`CHUNK_CANDIDATES` largest-first, pairs each with the block
    for that dispatch size (:func:`block_for_terms`), and returns the first
    combination whose :func:`estimate_bytes` fits :func:`budget_bytes` of
    the device memory.  Always returns something: when nothing fits, the
    smallest estimate.
    """
    if hbm is None:
        hbm = device_hbm(device)
    budget = budget_bytes(hbm)
    best = None
    seen = set()
    for chunk in CHUNK_CANDIDATES:
        c = min(chunk, n_terms)
        if c in seen:
            continue
        seen.add(c)
        b = min(block_for_terms(c), n_orders)
        est = estimate_bytes(b, c, nt, n_mu, use_zout, imat_surf)
        if est <= budget:
            return b, c
        if best is None or est < best[0]:
            best = (est, (b, c))
    return best[1]
