"""Content-addressed product cache (the reference's file-memoization layer).

The reference caches its expensive intermediate products on disk under
parameter-encoded names and skips recomputation when the file exists: Mie
files (``SOS_NOM_FICMIE``, ``src/SOS_AEROSOLS.F:3128``; existence check
``:1260``) and surface BRDF/BPDF matrix files (``SOS_NOM_FIC_SURFACE.F:114``;
check ``src/SOS_SURFACE.F:585-603``).  Here the same scheme is one generic
keyed ``.npz`` store: the key encodes every generating parameter (readable
prefix + SHA1 of the full canonical parameter string), arrays are the
values.

Disabled unless a cache directory is configured — set ``$RTSOS_PRODUCT_CACHE``
or call :func:`set_cache_dir`.  Concurrent writers are safe (atomic rename,
matching the reference's tmp-file + ``mv`` dance,
``src/SOS_AEROSOLS.F:1443-1456``).
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Callable, Optional

import numpy as np

_cache_dir: Optional[str] = None
_STATS = {"hits": 0, "misses": 0}


#: compile-cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is not
#: set: one fixed path inside the checkout (listed in ``.gitignore``).  A
#: fixed path matters: it is part of the cache key, so a moving directory
#: never hits.
COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> None:
    """Enable JAX's persistent compilation cache for this process.

    Cold runs are compile-dominated (every solver shape and the per-bucket
    Mie recurrences), so a fresh process that finds its executables on
    disk starts much sooner.  Called idempotently from :func:`proc.run`
    so library users get it without the CLI's explicit wiring.  Where
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself), or a
    directory was configured otherwise, no other directory is set;
    otherwise the cache goes to :data:`COMPILE_CACHE_DIR`.
    ``RTSOS_NO_COMPILE_CACHE`` opts out.
    """
    import jax

    if os.environ.get("RTSOS_NO_COMPILE_CACHE"):
        return
    if not jax.config.jax_compilation_cache_dir:
        os.makedirs(COMPILE_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


def set_cache_dir(path: Optional[str]) -> None:
    """Enable (or disable with None) the product cache."""
    global _cache_dir
    _cache_dir = path
    if path:
        os.makedirs(path, exist_ok=True)


def cache_dir() -> Optional[str]:
    if _cache_dir is not None:
        return _cache_dir
    env = os.environ.get("RTSOS_PRODUCT_CACHE")
    if env:
        os.makedirs(env, exist_ok=True)
        return env
    return None


def cache_stats() -> dict:
    return dict(_STATS)


def _canonical(params: dict) -> str:
    """Deterministic parameter encoding; arrays hash by content."""
    parts = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, np.ndarray):
            h = hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()
            parts.append(f"{k}=ndarray{v.shape}:{h[:12]}")
        elif isinstance(v, float):
            parts.append(f"{k}={v!r}")       # full precision like the
        else:                                # reference's format encoding
            parts.append(f"{k}={v}")
    return ";".join(parts)


#: in-process layer over the disk store: a LUT sweep re-reads the same
#: Mie/surface products for every case (measured: ~75 ms per npz reload
#: through the 2-core host); bounded FIFO so long sweeps cannot grow it
_MEM: dict = {}
_MEM_MAX = 64


def memo(prefix: str, params: dict,
         compute: Callable[[], dict]) -> dict:
    """Return the cached arrays for (prefix, params), computing on miss.

    ``compute`` returns a dict of numpy arrays (or scalars, stored as
    0-d arrays).  With no cache directory configured this is a plain call.
    Two layers: an in-process dict (per-sweep reuse) over the on-disk
    ``.npz`` store (cross-run reuse, the reference's product files).
    """
    d = cache_dir()
    if d is None:
        return compute()
    digest = hashlib.sha1(_canonical(params).encode()).hexdigest()[:20]
    mkey = (prefix, digest)

    def fresh(out):
        # callers have always received freshly-loaded arrays they may
        # mutate; hand out copies so the memory layer stays pristine
        return {k: np.array(v) for k, v in out.items()}

    if mkey in _MEM:
        _STATS["hits"] += 1
        return fresh(_MEM[mkey])

    def keep(out):
        if len(_MEM) >= _MEM_MAX:
            _MEM.pop(next(iter(_MEM)))
        _MEM[mkey] = out
        return fresh(out)

    path = os.path.join(d, f"{prefix}_{digest}.npz")
    if os.path.exists(path):
        _STATS["hits"] += 1
        with np.load(path) as z:
            return keep({k: z[k] for k in z.files})
    _STATS["misses"] += 1
    out = {k: np.asarray(v) for k, v in compute().items()}
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **out)
        os.replace(tmp, path)               # atomic, like the mv (:1456)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return keep(out)
