"""bench.py's device table and its refusal to run without a GPU."""

import json
import os
import subprocess
import sys

import pytest

import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("kind,hbm", [("NVIDIA H100 80GB HBM3", 3350.0),
                                      ("NVIDIA H100 PCIe", 2000.0)])
def test_peaks_found_for_h100(kind, hbm):
    pk = bench.peaks(kind)
    assert pk["hbm_gbps"] == hbm
    assert pk["bf16"] > pk["tf32"] > pk["f32"] > 0


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-80GB", "cpu", ""])
def test_unknown_device_kind_is_an_error(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        bench.peaks(kind)


def test_every_policy_has_a_peak():
    for pol in ("highest", "high", "bf16", "native", "ozaki", "default"):
        assert bench.POLICY_PEAK[pol] in bench.PEAKS["H100 80GB HBM3"]


def test_bench_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu", BENCH_SKIP_WARMUP="1")
    r = subprocess.run([sys.executable, "bench.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["value"] == 0.0 and "no accelerator found" in last["error"]
