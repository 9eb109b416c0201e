"""chip_smoke.py: its phases at tiny sizes on the CPU engine, its refusal of
a machine without a GPU, and (on a card only) the script itself."""

import json
import os
import subprocess
import sys

import pytest

import chip_smoke
from runmat_tpu.accel import active_engine, init_engine, reset_engine, set_engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = {"elementwise_math": {"points": 20000},
        "monte_carlo": {"M": 4096, "T": 8},
        "image_normalize": {"B": 2, "H": 32, "W": 48}}


@pytest.fixture
def cpu_engine():
    """A CPU engine that offloads like the GPU one does, so the scripts
    take the device path."""
    prev = active_engine()
    reset_engine()
    yield init_engine(platform="cpu", auto_offload=True,
                      offload_threshold=1024)
    set_engine(prev)


def _no_gpu_env():
    env = dict(os.environ)
    env.pop("RUNMAT_TPU_PLATFORM", None)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_main_refuses_cpu_in_process(capsys):
    assert chip_smoke.main([]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "no GPU found" in err


def test_script_exits_nonzero_without_gpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=_no_gpu_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU found" in r.stderr


def test_main_path_phase_tiny(cpu_engine):
    out = chip_smoke.main_path_phase(sizes=TINY, warm_runs=1)
    assert set(out) == {s[0] for s in chip_smoke.SCRIPTS}
    for name, _, _, rtol in chip_smoke.SCRIPTS:
        runs = out[name]["runs"]
        assert len(runs) == 2 and out[name]["rel_diff"] <= rtol
        assert runs[0]["dispatches"] > 0, name        # device path taken
        assert all(r["host_fallbacks"] == 0 for r in runs)
    # warm runs reuse the cold run's executables
    assert out["monte_carlo"]["runs"][1]["compiles"] == 0


def test_main_path_phase_fails_on_host_mismatch(cpu_engine, monkeypatch):
    """A device result outside the tolerance fails the phase."""
    monkeypatch.setattr(chip_smoke, "SCRIPTS",
                        (("elementwise_math", "y2", "checksum", -1.0),))
    with pytest.raises(chip_smoke.PhaseFailed, match="elementwise_math"):
        chip_smoke.main_path_phase(sizes=TINY, warm_runs=0)


def test_battery_phase_reports_eig_route(cpu_engine):
    out = chip_smoke.battery_phase()
    assert out["passed"] == out["checks"]
    assert out["eig_route"] == "device eig_full"


def test_precision_phase_tiny(cpu_engine):
    out = chip_smoke.precision_phase(sizes=(64, 96), policy_n=64)
    assert out["maxrel_64"] < 1e-4
    assert {"highest", "high", "bf16"} <= set(out)
    assert out["highest"]["precision"] == "HIGHEST"
    assert cpu_engine.matmul_precision == "highest"    # policy restored


def test_decisions_phase_tiny(cpu_engine):
    out = chip_smoke.decisions_phase(gemm_sizes=(64,), hist_n=10000,
                                     hist_bins=8, reps=1)
    row = out["gemm_f64"][64]
    assert row["native"]["maxrel"] < 1e-13
    assert row["ozaki"]["maxrel"] < 1e-10
    assert out["histcounts"]["exact"]


def test_mesh_phase_on_four_virtual_devices():
    prev = active_engine()
    try:
        out = chip_smoke.mesh_phase(
            n_devices=4, platform="cpu", paths=65536, steps=4, gemm_n=32,
            fft_n=256, unique_n=4096, solve_n=32)
    finally:
        set_engine(prev)
    assert out["monte_carlo"]["spec"] == ("data",)
    assert out["gemm"]["specs"] == (("data", "model"),) * 2
    assert all(s[0] == "data" for s in out["sweep"]["specs"].values())


@pytest.fixture
def gpu_card():
    """Skip unless this machine has an NVIDIA card (asked of nvidia-smi, so
    this process stays off the card)."""
    try:
        r = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        pytest.skip("no nvidia-smi: no GPU on this machine")
    if r.returncode != 0 or "GPU" not in r.stdout:
        pytest.skip("nvidia-smi lists no GPU")


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_card):
    env = dict(os.environ)
    for k in ("JAX_PLATFORMS", "RUNMAT_TPU_PLATFORM", "XLA_FLAGS"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
    assert last["device"]["count"] >= 1
