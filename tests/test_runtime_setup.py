"""Process-level setup: compile-cache placement and chip_smoke.py's
refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env_extra, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(JAX_PLATFORMS="cpu", **env_extra)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()[-1]


_CODE = ("import jax\n"
         "from vsmartmom.util.compile_cache import enable_compile_cache\n"
         "print(enable_compile_cache(), "
         "jax.config.jax_compilation_cache_dir)\n")


def test_compile_cache_in_checkout_when_env_unset():
    got, cfg = _run(_CODE, {}, drop=("JAX_COMPILATION_CACHE_DIR",)).split()
    assert got == cfg == os.path.join(ROOT, ".jax_cache")


def test_compile_cache_follows_env(tmp_path):
    want = str(tmp_path / "cache")
    got, cfg = _run(_CODE, {"JAX_COMPILATION_CACHE_DIR": want}).split()
    assert got == cfg == want


def _smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _smoke(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
