"""The device conformance battery must pass CPU-pinned (same programs that
chip_smoke.py runs on the GPU; a divergence there then isolates real
device-vs-CPU behavior, not a stale expectation)."""

from helpers import run
from runmat_tpu import device_battery


def test_smoke_battery_all_pass_cpu():
    s = run("x = 1;", accelerate=True)
    res = device_battery.run(s)
    assert res["failed"] == 0, res["failures"]
    assert res["passed"] == sum(len(c[2]) for c in device_battery.CASES)


class _Result:
    def __init__(self, error=None):
        self.error = error


class _FakeSession:
    """Scripted session keyed by case SOURCE: 'ok' (program runs, every
    variable reads back 1.0), 'error' (the program fails) or 'raise' (the
    call itself raises)."""

    def __init__(self, by_src):
        self.by_src = dict(by_src)

    def execute(self, src):
        mode = self.by_src.get(src, "ok")
        if mode == "raise":
            raise RuntimeError("backend error")
        if mode == "error":
            return _Result(RuntimeError("wrong answer"))
        return _Result(None)

    def get(self, var):
        import numpy as np
        return np.array([1.0])


def test_program_error_fails_its_checks_and_the_rest_still_run(monkeypatch):
    """A failing program counts every check of its case as failed; nothing
    is skipped or retried, and later cases still run."""
    cases = [("c0", "s0", (("v", 1.0, 0),)),
             ("c1", "s1", (("v", 1.0, 0), ("w", 1.0, 0))),
             ("c2", "s2", (("v", 1.0, 0),))]
    monkeypatch.setattr(device_battery, "CASES", cases)
    out = device_battery.run(_FakeSession({"s1": "error"}))
    assert out == {"passed": 2, "failed": 2, "cases": 3,
                   "failures": [out["failures"][0]]}
    assert out["failures"][0].startswith("c1: program error")


def test_raising_session_counts_as_failure(monkeypatch):
    cases = [("c0", "s0", (("v", 1.0, 0),)), ("c1", "s1", (("v", 1.0, 0),))]
    monkeypatch.setattr(device_battery, "CASES", cases)
    out = device_battery.run(_FakeSession({"s0": "raise"}))
    assert out["passed"] == 1 and out["failed"] == 1
    assert "RuntimeError" in out["failures"][0]


def test_wrong_value_is_reported(monkeypatch):
    cases = [("c0", "s0", (("v", 2.0, 0),))]
    monkeypatch.setattr(device_battery, "CASES", cases)
    out = device_battery.run(_FakeSession({}))
    assert out["failed"] == 1 and out["failures"][0].startswith("c0.v: got")
