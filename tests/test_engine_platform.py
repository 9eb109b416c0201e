"""The engine finds its device honestly: an accelerator asked for is never
replaced by the CPU, an auto session says once why it runs on the host, and
the compile cache is JAX_COMPILATION_CACHE_DIR or a fixed in-checkout path."""

import os
import subprocess
import sys

import pytest

from runmat_tpu import session as session_mod
from runmat_tpu.accel import active_engine, reset_engine, set_engine
from runmat_tpu.accel.engine import JaxEngine, compile_cache_dir
from runmat_tpu.errors import MatError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def unpinned(monkeypatch):
    """No RUNMAT_TPU_PLATFORM: the engine takes what JAX reports (the CPU
    here), as it would on a machine whose CUDA plugin failed to load."""
    monkeypatch.delenv("RUNMAT_TPU_PLATFORM", raising=False)
    prev = active_engine()
    reset_engine()
    yield
    set_engine(prev)


def test_required_engine_refuses_unpinned_cpu(unpinned):
    with pytest.raises(MatError, match="no accelerator found"):
        JaxEngine(required=True)


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_required_engine_accepts_pinned_cpu(unpinned, monkeypatch, how):
    if how == "environment":
        monkeypatch.setenv("RUNMAT_TPU_PLATFORM", "cpu")
        eng = JaxEngine(required=True)
    else:
        eng = JaxEngine(platform="cpu", required=True)
    assert eng.platform == "cpu"


def test_unrequired_engine_runs_on_unpinned_cpu(unpinned):
    assert JaxEngine().platform == "cpu"


def test_session_accelerate_true_raises_on_unpinned_cpu(unpinned):
    with pytest.raises(MatError, match="no accelerator found"):
        session_mod.Session(accelerate=True)


def test_auto_session_logs_host_fallback_once(unpinned, monkeypatch,
                                              capsys):
    from runmat_tpu import accel

    def broken(**kw):
        raise RuntimeError("plugin failed")
    monkeypatch.setattr(accel, "init_engine", broken)
    monkeypatch.setattr(session_mod, "_HOST_ONLY_NOTED", False)
    s1 = session_mod.Session()
    session_mod.Session()
    err = capsys.readouterr().err
    assert err.count("running on the host") == 1
    assert "RuntimeError: plugin failed" in err
    r = s1.execute("x = 1 + 1;")                  # still works, on host
    assert r.error is None


def test_compile_cache_dir_defers_to_env(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    assert compile_cache_dir() is None


def test_compile_cache_dir_default_is_in_checkout_and_ignored(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache_dir()
    assert path == os.path.join(ROOT, ".cache", "jax")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".cache/" in f.read().split()


_PROBE = ("from runmat_tpu.session import Session; Session(accelerate=True); "
          "import jax; print(jax.config.jax_compilation_cache_dir)")


@pytest.mark.parametrize("env_dir", [True, False], ids=["env_set", "unset"])
def test_session_compile_cache_config(tmp_path, env_dir):
    env = dict(os.environ, RUNMAT_TPU_PLATFORM="cpu", JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(ROOT, ".cache", "jax")
    if env_dir:
        want = str(tmp_path / "xla")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == want
