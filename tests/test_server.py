"""Session server: execute_request ABI over JSON lines (in-process + via a
spawned `serve` subprocess, the transport the TS bindings use)."""

import json
import os
import subprocess
import sys

from helpers import run
from runmat_tpu.server import handle_request
from runmat_tpu.session import Session


def _sess():
    return Session(accelerate=False)


def test_execute_ok_and_error():
    s = _sess()
    r = handle_request(s, {"id": 1, "op": "execute", "source": "x = 2 + 3; disp(x)"})
    assert r["ok"] and "5" in r["output"]
    r2 = handle_request(s, {"id": 2, "op": "execute", "source": "undefined_fn_xyz()"})
    assert not r2["ok"]
    assert "identifier" in r2["error"]


def test_workspace_and_get():
    s = _sess()
    handle_request(s, {"id": 1, "op": "execute", "source": "a = [1 2; 3 4]; msg = 'hi';"})
    ws = handle_request(s, {"id": 2, "op": "workspace"})["workspace"]
    assert ws["a"]["class"] == "double" and ws["a"]["size"] == [2, 2]
    assert ws["msg"]["value"] == "hi"
    v = handle_request(s, {"id": 3, "op": "get", "name": "a"})["value"]
    assert v["value"] == [[1.0, 2.0], [3.0, 4.0]]
    missing = handle_request(s, {"id": 4, "op": "get", "name": "zz"})
    assert not missing["ok"]


def test_reset_accel_info_unknown():
    s = _sess()
    handle_request(s, {"id": 1, "op": "execute", "source": "q = 1;"})
    handle_request(s, {"id": 2, "op": "reset"})
    assert handle_request(s, {"id": 3, "op": "workspace"})["workspace"] == {}
    info = handle_request(s, {"id": 4, "op": "accel_info"})["accel"]
    assert "available" in info
    bad = handle_request(s, {"id": 5, "op": "nope"})
    assert not bad["ok"]


def test_serve_subprocess_roundtrip():
    env = dict(os.environ)
    env["RUNMAT_TPU_PLATFORM"] = "cpu"
    p = subprocess.Popen(
        [sys.executable, "-m", "runmat_tpu.cli", "serve"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    reqs = [
        {"id": 1, "op": "execute", "source": "x = sum(1:10);"},
        {"id": 2, "op": "get", "name": "x"},
        {"id": 3, "op": "shutdown"},
    ]
    out, _ = p.communicate("\n".join(json.dumps(r) for r in reqs) + "\n",
                           timeout=120)
    lines = [json.loads(l) for l in out.strip().split("\n")]
    assert lines[0]["ok"]
    assert lines[1]["value"]["value"] == [[55.0]]
    assert lines[2]["shutdown"]


def test_fusion_plans_op():
    s = Session(accelerate=True)
    handle_request(s, {"id": 1, "op": "execute",
                       "source": "x = gpuArray(ones(64)); y = gather(sum(sin(x) + 1, 'all'));"})
    r = handle_request(s, {"id": 2, "op": "fusion_plans"})
    assert r["ok"]
    assert isinstance(r["plans"], list)
    if r["plans"]:
        assert "ops" in r["plans"][0] and "kind" in r["plans"][0]


def test_hover_op():
    s = _sess()
    handle_request(s, {"id": 1, "op": "execute",
                       "source": "M = magic(4); name = 'hi';"})
    r = handle_request(s, {"id": 2, "op": "hover", "name": "M"})
    assert r["ok"] and r["hover"]["name"] == "M"
    assert r["hover"]["size"] == [4, 4]
    assert "preview" in r["hover"]
    r2 = handle_request(s, {"id": 3, "op": "hover", "name": "nope"})
    assert not r2["ok"]


def test_builtins_catalog_op():
    s = _sess()
    r = handle_request(s, {"id": 1, "op": "builtins", "query": "sin"})
    assert r["ok"]
    names = [b["name"] for b in r["builtins"]]
    assert "sin" in names and "asin" in names
    r2 = handle_request(s, {"id": 2, "op": "builtins"})
    assert r2["total"] > 1000


def test_check_op_reports_findings():
    s = _sess()
    r = handle_request(s, {"id": 1, "op": "check",
                           "source": "y = undefined_thing_xyz + 1;"})
    assert r["ok"] and any("undefined_thing_xyz" in f["message"]
                           for f in r["findings"])


def test_telemetry_op():
    s = Session(accelerate=None)
    r = handle_request(s, {"id": 1, "op": "telemetry"})
    assert r["ok"] and "session" in r["telemetry"]


def test_http_bridge_serves_repl_and_api(tmp_path):
    """serve --http: browser REPL page + POST /api request ABI (the
    wasm-embedding analog: session stays server-side next to the card)."""
    import threading
    import time
    import urllib.request
    from runmat_tpu.server import serve_http

    s = _sess()
    # pick a free port by binding our own server object
    import http.server as hs
    import runmat_tpu.server as srv_mod

    holder = {}

    TOKEN = "test-token-abc123"

    def run_server():
        # serve_http blocks; capture the port via monkeypatching print? —
        # simpler: use a fixed high port with retry
        serve_http(s, "127.0.0.1", holder["port"], token=TOKEN)

    import socket
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    holder["port"] = sock.getsockname()[1]
    sock.close()
    t = threading.Thread(target=run_server, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{holder['port']}"
    for _ in range(50):
        try:
            page = urllib.request.urlopen(
                base + "/?token=" + TOKEN, timeout=1).read()
            break
        except urllib.error.HTTPError:
            raise
        except OSError:
            time.sleep(0.1)
    else:
        raise AssertionError("http server did not come up")
    assert b"runmat-tpu web REPL" in page
    hdrs = {"Content-Type": "application/json", "X-Runmat-Token": TOKEN}
    req = urllib.request.Request(
        base + "/api",
        data=json.dumps({"id": 1, "op": "execute",
                         "source": "z = 6*7; disp(z)"}).encode(),
        headers=hdrs)
    resp = json.loads(urllib.request.urlopen(req, timeout=5).read())
    assert resp["ok"] and "42" in resp["output"]
    req2 = urllib.request.Request(
        base + "/api",
        data=json.dumps({"id": 2, "op": "workspace"}).encode(),
        headers=hdrs)
    resp2 = json.loads(urllib.request.urlopen(req2, timeout=5).read())
    assert resp2["workspace"]["z"]["value"] == [[42.0]]

    # --- security guard battery (ADVICE r2 high: drive-by RCE hardening) ---
    import urllib.error

    def status_of(url, data=None, headers=None):
        try:
            r = urllib.request.urlopen(
                urllib.request.Request(url, data=data, headers=headers or {}),
                timeout=5)
            return r.status
        except urllib.error.HTTPError as e:
            return e.code

    body = json.dumps({"id": 9, "op": "execute", "source": "1+1"}).encode()
    # no token → 403 on both surfaces
    assert status_of(base + "/") == 403
    assert status_of(base + "/api", body,
                     {"Content-Type": "application/json"}) == 403
    # wrong token → 403
    assert status_of(base + "/api", body,
                     {"Content-Type": "application/json",
                      "X-Runmat-Token": "nope"}) == 403
    # cross-site Origin → 403 even with the right token
    assert status_of(base + "/api", body,
                     {"Content-Type": "application/json",
                      "X-Runmat-Token": TOKEN,
                      "Origin": "http://evil.example.com"}) == 403
    # DNS-rebinding Host header → 403
    assert status_of(base + "/api", body,
                     {"Content-Type": "application/json",
                      "X-Runmat-Token": TOKEN,
                      "Host": "evil.example.com"}) == 403
    # text/plain body (no-preflight CSRF shape) → 415
    assert status_of(base + "/api", body,
                     {"Content-Type": "text/plain",
                      "X-Runmat-Token": TOKEN}) == 415
    # localhost Origin with the right token still works
    assert status_of(base + "/api", body,
                     {"Content-Type": "application/json",
                      "X-Runmat-Token": TOKEN,
                      "Origin": f"http://127.0.0.1:{holder['port']}"}) == 200


def test_figures_op_returns_svg():
    s = _sess()
    handle_request(s, {"id": 0, "op": "execute", "source": "close all"})
    handle_request(s, {"id": 1, "op": "execute",
                       "source": "x = linspace(0, 2*pi, 50); plot(x, sin(x));"
                                 " title('wave');"})
    r = handle_request(s, {"id": 2, "op": "figures"})
    assert r["ok"] and r["figures"]
    svg = r["figures"][0]["svg"]
    assert "<svg" in svg
    assert "wave" in svg
    handle_request(s, {"id": 3, "op": "execute", "source": "close all"})
    r2 = handle_request(s, {"id": 4, "op": "figures"})
    assert r2["figures"] == []


def test_builtins_op_typed_registry_metadata():
    """The builtin catalog op carries the full typed spec (summary, arity,
    accel/sink/extension flags) for the TS bindings' typed registry."""
    s = _sess()
    r = handle_request(s, {"id": 1, "op": "builtins", "query": "sin"})
    assert r["ok"]
    sin = next(b for b in r["builtins"] if b["name"] == "sin")
    for key in ("summary", "min_in", "max_in", "max_out", "accel", "sink",
                "extension"):
        assert key in sin
    assert isinstance(sin["summary"], str)
    assert sin["extension"] is False
    r2 = handle_request(s, {"id": 2, "op": "builtins", "query": "accelInfo"})
    ext = next((b for b in r2["builtins"] if b["name"] == "accelInfo"), None)
    assert ext is not None and ext["extension"] is True


def test_ts_dist_mirror_covers_index_ts_surface():
    """dist/index.js (the runnable ESM build) must expose every session
    method and protocol op that index.ts declares — guards against drift
    between the typed source and the shipped build."""
    import re
    import pathlib
    root = pathlib.Path(__file__).resolve().parent.parent / "bindings" / "ts"
    ts = (root / "index.ts").read_text()
    js = (root / "dist" / "index.js").read_text()
    ts_methods = set(re.findall(r"^  async (\w+)\(", ts, re.M))
    js_methods = set(re.findall(r"^  async (\w+)\(", js, re.M))
    assert ts_methods and ts_methods <= js_methods, \
        ts_methods - js_methods
    ts_ops = set(re.findall(r'op: "(\w+)"', ts))
    js_ops = set(re.findall(r'op: "(\w+)"', js))
    assert ts_ops == js_ops
    assert "RunMatError" in js and "RunMatError" in ts


def test_ts_bindings_node_suite():
    """Run the node:test suite against the real server when node exists
    (vitest-suite analog; skipped in node-less environments)."""
    import pathlib
    import shutil
    import subprocess
    import pytest as _pytest
    if shutil.which("node") is None:
        _pytest.skip("node not available")
    root = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        ["node", "--test", "test/"],
        cwd=str(root / "bindings" / "ts"),
        env={**os.environ, "RUNMAT_TPU_PLATFORM": "cpu",
             "PYTHONPATH": str(root)},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_host_header_ok_ipv6_forms():
    """ADVICE r3: a portless bracketed IPv6 Host header ("[::1]") must be
    accepted; rsplit-based parsing mangled it into ":"."""
    from runmat_tpu.server import host_header_ok
    assert host_header_ok("[::1]", "127.0.0.1")
    assert host_header_ok("[::1]:8080", "127.0.0.1")
    assert host_header_ok("localhost", "127.0.0.1")
    assert host_header_ok("localhost:9000", "127.0.0.1")
    assert host_header_ok("127.0.0.1:80", "127.0.0.1")
    assert not host_header_ok("evil.example.com", "127.0.0.1")
    assert not host_header_ok("evil.example.com:80", "127.0.0.1")
    assert not host_header_ok("", "127.0.0.1")
