"""What the program needs from its platform: no OpenCV on the main path,
one compile cache, and a smoke script that refuses to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=600,
    )


def test_fast_test_runs_without_opencv(tmp_path):
    """The fast-test run (insel, sparse SfM) with cv2 made unimportable."""
    out = tmp_path / "out"
    code = (
        "import sys; sys.modules['cv2'] = None\n"
        "from sfm_mvs_pipeline.cli.app import main\n"
        f"rc = main(['-Prun=photogrammetrie', '-Pimage={ROOT}/sample_data/insel',"
        f" '-Pout={out}', '-Ploglevel=4'])\n"
        "assert 'cv2' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
        "sys.exit(rc)\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert (out / "pointcloud_sparse.ply").stat().st_size > 0
    assert (out / "scene.npz").exists()


@pytest.mark.parametrize("with_env", [False, True])
def test_compile_cache_dir(tmp_path, with_env):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache and
    nothing else is set; without it, the cache is <checkout>/.jax_cache."""
    code = (
        "import jax\n"
        "from sfm_mvs_pipeline.utils.compile_cache import enable_compile_cache\n"
        "d = enable_compile_cache()\n"
        "print(d); print(jax.config.jax_compilation_cache_dir)\n"
    )
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if with_env else {}
    r = _run(code, env)
    assert r.returncode == 0, r.stderr
    returned, configured = r.stdout.split()[-2:]
    want = str(tmp_path) if with_env else os.path.join(ROOT, ".jax_cache")
    assert returned == configured == want


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result on the CPU backend,
    and in a directory holding nothing of the repo but the script."""
    cwd = ROOT
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path)
        cwd, script = str(tmp_path), str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
