"""Command-line driver: the ``SOS_ABS_MAIN.exe`` keyword interface.

Re-design of ``PROGRAM SOS_ABS_MAIN`` (``src/SOS_ABS_MAIN.F:995``): argv is
a flat list of ``-Section.Name value`` pairs (parser ``:1490-2089``), the
pipeline runs once, and the ASCII radiance/transmission/flux products are
written under ``<ResRoot>/SOS``.  Exit status 1 on any error, matching the
reference's ``CALL EXIT(1)`` contract (``src/SOS_ABS_MAIN.F:3073-3084``).

Usage::

    python -m radiativetransfer_sos_tpu -SOS_Main.Wa 0.440 -ANG.Thetas 30 \
        -SURF.Type 0 -SURF.Alb 0.1 -AP.AbsProfile.Type 7 -SOS.View 1 \
        -SOS.View.Phi 0 -SOS_Main.ResRoot ./out
"""

from __future__ import annotations

import os
import sys

from .api import config_from_keywords, write_result_files
from .proc import sos_run


def parse_argv(argv: list[str]) -> dict:
    """argv ``-Keyword value`` pairs -> keyword dict."""
    if len(argv) % 2 != 0:
        raise ValueError("arguments must be -Keyword value pairs")
    kw = {}
    for i in range(0, len(argv), 2):
        key = argv[i]
        if not key.startswith("-") or key[1:2].isdigit():
            raise ValueError(f"expected a -Keyword, got {key!r}")
        kw[key] = argv[i + 1]
    return kw


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    import jax
    # honor JAX_PLATFORMS even when jax was imported and its platform
    # pinned through jax.config before this point (env vars lose to config
    # updates).  The CPU backend must stay AVAILABLE (not default) beside
    # the accelerator: the f64 Mie sweep and the host-side output path run
    # on it (mie.run_mie_sweep pins jax.devices("cpu")).  A listed platform
    # that fails to start is an error, never a silent move to the CPU.
    plat = (os.environ.get("JAX_PLATFORMS")
            or (jax.config.jax_platforms or "")).strip().strip(",")
    if plat and "cpu" not in plat.split(","):
        plat = plat + ",cpu"
    if plat:
        jax.config.update("jax_platforms", plat)
    jax.config.update("jax_enable_x64", True)   # reference is f64 throughout
    # persistent compile cache — the analogue of the reference's on-disk
    # product-file memoization (SURVEY.md §5 checkpoint/resume)
    from .cache import enable_compile_cache
    enable_compile_cache()
    try:
        cfg = config_from_keywords(parse_argv(argv))
        res = sos_run(cfg)
        write_result_files(cfg, res)
    except Exception as exc:   # reference prints and returns 1 (:3073-3084)
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1
    print("JOB_STATUS=OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
