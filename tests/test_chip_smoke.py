"""``chip_smoke.py`` and the compile-cache placement, on the CPU."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env_extra, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_extra, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    """On the CPU the script stops before any phase, prints no result and
    exits non-zero."""
    p = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr


_SHOW = ("import jax; from radiativetransfer_sos_tpu import cache; "
         "cache.enable_compile_cache(); "
         "print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_env_dir_wins(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, that directory and no other."""
    want = str(tmp_path / "cc")
    p = _run(_SHOW, {"JAX_COMPILATION_CACHE_DIR": want},
             drop=("RTSOS_NO_COMPILE_CACHE",))
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == want


def test_compile_cache_default_in_checkout():
    """Without it, one fixed directory inside the checkout, ignored by
    git."""
    p = _run(_SHOW, {}, drop=("JAX_COMPILATION_CACHE_DIR",
                              "RTSOS_NO_COMPILE_CACHE"))
    assert p.returncode == 0, p.stderr
    got = p.stdout.strip()
    assert got == os.path.join(ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
