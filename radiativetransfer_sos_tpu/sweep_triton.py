"""Layer sweep on an NVIDIA GPU: a Pallas kernel on the Triton route.

The layer integration of one scattering order (reference
``SOS_INTEGR_EPOPT``, ``src/SOS_OS.F:2222-2354``) is, for every (instance,
direction) column of the flat field, a first-order affine recurrence over
the NT+1 optical-depth levels::

    down:  f[l] = att(l-1, l) * f[l-1] + bd(l)     l = 1..LP-1, f[0] = 0
    up:    f[l] = att(l, l+1) * f[l+1] + bu(l)     l = LP-2..0, f[LP-1] = bc

with ``att = exp(-dtau / mu)`` and the linear-in-tau source terms of
``solver._sweep_flat_scan`` (its reference).  The columns are independent,
so no scan tree is needed: one program (one warp) owns one instance and
one block of :data:`LANES` direction columns of both hemispheres, walks
the levels in a loop with the running field in registers, reads each
source row once and writes each field row once.  Zero-thickness (padding) layers have
``att = 1`` and ``b = 0``: exact identity steps.

The kernel serves float32 and float64 fields alike.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: direction columns per program (a power of two dividing the 128-padded
#: hemisphere width; 128 beat 64 and 32 on an H100, ``PERF.md``)
LANES = 128


def _sweep_kernel(h_ref, mu_ref, src_ref, bc_ref, out_ref):
    """One (instance, lane block): ``h_ref`` (LP,) depths, ``mu_ref`` (L,)
    direction cosines, ``src_ref``/``out_ref`` (LP, 2, L) rows of the
    [up, down] hemispheres, ``bc_ref`` (L,) upward ground boundary."""
    n_lev = src_ref.shape[0]
    mu = mu_ref[...]

    def step(dtau, s_near, s_far):
        # per-layer attenuation and source slope (safe at dtau = 0)
        pos = dtau > 0.0
        att = jnp.exp(-dtau / mu)
        al = jnp.where(pos, (s_far - s_near) / jnp.where(pos, dtau, 1.0), 0.0)
        return att, al

    def down(l, carry):
        f, s_prev = carry
        s = src_ref[l, 1, :]
        dtau = h_ref[l] - h_ref[l - 1]
        att, al = step(dtau, s_prev, s)
        f = att * f + ((1.0 - att) * (-al * mu + s) + al * att * dtau)
        out_ref[l, 1, :] = f
        return f, s

    zero = jnp.zeros_like(mu)
    out_ref[0, 1, :] = zero
    lax.fori_loop(1, n_lev, down, (zero, src_ref[0, 1, :]))

    def up(i, carry):
        f, s_next = carry
        l = n_lev - 2 - i
        s = src_ref[l, 0, :]
        dtau = h_ref[l + 1] - h_ref[l]
        att, al = step(dtau, s, s_next)
        f = att * f + ((1.0 - att) * (al * mu + s) - al * att * dtau)
        out_ref[l, 0, :] = f
        return f, s

    bc = bc_ref[...]
    out_ref[n_lev - 1, 0, :] = bc
    lax.fori_loop(0, n_lev - 1, up, (bc, src_ref[n_lev - 1, 0, :]))


@functools.partial(jax.jit, static_argnames=("interpret",))
def sweep(h, mu_half, src, bc, interpret: bool = False):
    """Integrate both hemispheres of a flat field batch.

    ``h``: (T, LP) cumulative optical depths per term; ``mu_half``: (HP,)
    direction cosines of one hemisphere (pad slots 1); ``src``: (B, LP, W)
    flat sources, ``W = 2*HP``, with the B = S*T instances order-major
    (instance ``s*T + t`` uses ``h[t]``); ``bc``: (B, HP) upward ground
    boundary.  Returns the field at every level, (B, LP, W), laid out as
    ``src``.
    """
    b_n, lp, w = src.shape
    t_n = h.shape[0]
    hp = w // 2
    lanes = min(LANES, hp)
    src4 = src.reshape(b_n, lp, 2, hp)
    blk = pl.BlockSpec((None, lp, 2, lanes), lambda b, j: (b, 0, 0, j))
    out = pl.pallas_call(
        _sweep_kernel,
        grid=(b_n, hp // lanes),
        in_specs=[
            pl.BlockSpec((None, lp), lambda b, j: (b % t_n, 0)),
            pl.BlockSpec((lanes,), lambda b, j: (j,)),
            blk,
            pl.BlockSpec((None, lanes), lambda b, j: (b, j)),
        ],
        out_specs=blk,
        out_shape=jax.ShapeDtypeStruct(src4.shape, src.dtype),
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=2),
        interpret=interpret,
        name="sos_layer_sweep",
    )(h.astype(src.dtype), mu_half.astype(src.dtype), src4,
      bc.astype(src.dtype))
    return out.reshape(b_n, lp, w)
