"""Smoke test of the SOS solve on an NVIDIA GPU, in one process.

Run from the repository root on a machine with a GPU::

    python chip_smoke.py           # phases a-e on one card
    python chip_smoke.py --four    # the sharded paths on four cards

Phases (``radiativetransfer_sos_tpu/checks.py`` holds each body):

a. the two layers of the scattering loop at the demo widths (HP = 128,
   NT = 600, 8 orders x 512 terms): the layer-sweep kernel against the
   float64 scan on the CPU, the scattering-source matmul against a float64
   NumPy einsum;
b. the f32-vs-f64 precision gate at the demo shape;
c. a 512-term demo-shape batch through the blocked, chunked solve, with
   the planner's memory estimate held to the compiled executable;
d. the polarized ocean demo through ``proc.sos_run`` against the same case
   in float64 on the CPU;
e. the LUT factory, ``lut.sos_run_many(batch_cases=True)``, against the
   case-by-case path.

``--four`` runs only the two sharded comparisons (a (4, 1) and a (2, 2)
mesh).  Each phase prints one line with its dtype, wall time,
``peak_bytes_in_use`` (the process's peak so far), worst error and limit.
The last line is a JSON record ``{"ok": true, "device": {...}}``, printed
only when every phase passed; any failure exits non-zero.  Without a GPU
the script exits non-zero before any phase.
"""

import argparse
import json
import subprocess
import sys
import time
import traceback


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the sharded paths on four GPUs, nothing else")
    args = ap.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform} devices",
              file=sys.stderr)
        return 2
    if args.four and len(devices) < 4:
        print(f"--four needs four GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 2

    from radiativetransfer_sos_tpu import cache, checks, precision

    cache.enable_compile_cache()
    print(f"card: {_card_line()}")
    print(f"jax {jax.__version__}, compile cache "
          f"{jax.config.jax_compilation_cache_dir}")

    if args.four:
        phases = [("four.blocked_4x1", checks.sharded_blocked_check),
                  ("four.reduce_2x2", checks.sharded_reduce_check)]
    else:
        ref = {}

        def reference():
            if "i64" not in ref:
                ref["i64"] = precision.cpu_reference()
            return ref["i64"]

        phases = [
            ("a.sweep", checks.sweep_check),
            ("a.scatter", checks.scatter_check),
            ("b.precision_gate",
             lambda: checks.precision_gate(i64=reference())),
            ("c.blocked_512",
             lambda: checks.blocked_solve_check(i64=reference())),
            ("d.ocean_demo", checks.demo_polar_check),
            ("e.lut_factory", checks.lut_check),
        ]

    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            rec = fn()
        except Exception:
            traceback.print_exc()
            rec = {"ok": False, "error": traceback.format_exc(limit=1)}
        rec["wall_s"] = time.perf_counter() - t0
        rec["peak_bytes_in_use"] = \
            devices[0].memory_stats()["peak_bytes_in_use"]
        print(f"phase {name}: {json.dumps(rec)}", flush=True)
        ok = ok and bool(rec["ok"])
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
