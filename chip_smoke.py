#!/usr/bin/env python
"""Start the runtime on an NVIDIA GPU and check its device path end to end.

Run from the root of a checkout:

    python chip_smoke.py               # one card: every one-card phase
    python chip_smoke.py --four-cards  # four cards: only the mesh phase

One-card phases, all in this one process:

  device     the card's name and power limit (nvidia-smi, in a child that
             stays off JAX); Session(accelerate=True) must give a GPU engine.
  main path  benchmarks/{elementwise_math,monte_carlo,image_normalize}.m at
             their published sizes through Session.run_source, once cold and
             three times warm; each RESULT_ok value against the same script
             on the NumPy host path; no host fallback.
  battery    runmat_tpu.device_battery: every assertion passes, none skips.
  precision  `single` GEMM under the default policy against a float64
             product, and the dot precision each policy compiles to.
  decisions  native f64 GEMM against the Ozaki scheme, and the plain
             histcounts rate beside a copy.

Four-card phase: dp=4 Monte-Carlo, a 2x2-sharded f64 GEMM and a sharded
FFT/unique/cumsum/mldivide sweep, each against one card or the host, with
every sharded operand's mesh axes asserted.

Progress goes to stdout. The last line is one JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}. A
failed phase exits 1 without that line; a machine where JAX finds no GPU
exits 2.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# (script, variable the run blocks on, result variable printed by RESULT_ok,
#  relative tolerance against the host run). All three scripts are `single`.
#  * elementwise_math: a sin/exp/cos/tanh chain summed over 1024 points;
#    device and host libm differ by a few f32 ULPs per element (~1e-7).
#  * monte_carlo: the Threefry bits are identical on host and device, but
#    Box-Muller and the 256 multiplicative exp steps go through each
#    backend's libm, and the 1M-path mean is summed in another order: a few
#    f32 ULPs per step compound to ~1e-6 relative.
#  * image_normalize: rand is bit-exact; pow and the f32 means over 8.3M-
#    element frames and the 133M-element batch reassociate (~1e-6).
# 1e-4 leaves about a hundredfold margin over those estimates for the two
# longer pipelines, 1e-5 for the short chain.
SCRIPTS = (
    ("elementwise_math", "y2", "checksum", 1e-5),
    ("monte_carlo", "S", "price", 1e-4),
    ("image_normalize", "out", "mse", 1e-4),
)
WARM_RUNS = 3


class PhaseFailed(Exception):
    pass


def say(msg: str = "") -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def _maxrel(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300))


def _median_ms(fn, reps: int = 5) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def engine_off():
    """Deactivate the process's accelerator engine, so a session created
    inside runs on the NumPy host path."""
    from runmat_tpu import accel
    eng = accel.active_engine()
    accel.set_engine(None)
    try:
        yield
    finally:
        accel.set_engine(eng)


def _script(name: str) -> str:
    with open(os.path.join(ROOT, "benchmarks", f"{name}.m")) as f:
        return f.read()


def _run_script(sess, name: str, sizes: dict) -> str:
    """Run one benchmark script; returns its printed RESULT_ok line."""
    from runmat_tpu.values import MatArray
    buf = io.StringIO()
    for k, v in sizes.items():
        sess.set(k, MatArray(np.array([[float(v)]]), "double"))
    sess.stdout = buf
    try:
        sess.run_source(_script(name), name)
    finally:
        sess.stdout = sys.stdout
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("RESULT_ok")]
    check(len(lines) == 1, f"{name}: no RESULT_ok line in {buf.getvalue()!r}")
    return lines[0]


def _scalar(sess, var: str) -> float:
    return float(np.asarray(sess.get(var).host()).reshape(-1)[0])


def _peak_bytes(eng) -> object:
    stats = eng.device.memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not reported")


# --------------------------------------------------------------------- phases

def device_phase() -> dict:
    """The card as nvidia-smi and the engine see it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say(f"nvidia-smi: {smi}")
    from runmat_tpu.accel import active_engine
    from runmat_tpu.native import turbine
    from runmat_tpu.session import Session
    Session(accelerate=True)
    eng = active_engine()
    check(eng is not None and eng.platform == "gpu",
          f"engine platform is {getattr(eng, 'platform', None)}, not gpu")
    info = eng.device_info()
    say(f"engine: platform {eng.platform}, device_kind {info['name']}, "
        f"{info['count']} device(s), turbine library "
        f"{'loaded' if turbine() is not None else 'not loaded'}")
    return {"nvidia_smi": smi, "device_kind": info["name"]}


def main_path_phase(sizes: dict = None, warm_runs: int = WARM_RUNS) -> dict:
    """The three benchmark scripts on the device, each against the host.
    `sizes` maps a script to workspace overrides (tests shrink them)."""
    from runmat_tpu.accel import active_engine
    from runmat_tpu.session import Session
    sizes = sizes or {}
    sess = Session(accelerate=True)
    eng = active_engine()
    out = {}
    for name, block_var, result_var, rtol in SCRIPTS:
        sz = sizes.get(name, {})
        runs = []
        for i in range(1 + warm_runs):
            s0 = dict(eng.stats)
            t0 = time.perf_counter()
            line = _run_script(sess, name, sz)
            eng.block_until_ready(sess.get(block_var))
            ms = (time.perf_counter() - t0) * 1e3
            d = {k: eng.stats.get(k, 0) - s0.get(k, 0)
                 for k in ("compiles", "dispatches", "host_fallbacks")}
            runs.append(dict(ms=ms, **d))
            say(f"  {name} {'cold' if i == 0 else 'warm'}: {ms:.1f} ms, "
                f"compiles {d['compiles']}, dispatches {d['dispatches']}, "
                f"host_fallbacks {d['host_fallbacks']}")
        dev = _scalar(sess, result_var)
        peak = _peak_bytes(eng)
        sess.run_source("clear", "clear")
        with engine_off():
            host_sess = Session(accelerate=False)
            host_line = _run_script(host_sess, name, sz)
            host = _scalar(host_sess, result_var)
            del host_sess
        rel = abs(dev - host) / max(abs(host), 1e-300)
        say(f"  {name}: device '{line}' host '{host_line}', rel diff "
            f"{rel:.3e} (tolerance {rtol:g}), peak_bytes_in_use {peak}")
        fallbacks = sum(r["host_fallbacks"] for r in runs)
        check(fallbacks == 0, f"{name}: {fallbacks} host fallbacks")
        check(rel <= rtol, f"{name}: device {dev!r} vs host {host!r}")
        out[name] = {"runs": runs, "rel_diff": rel,
                     "peak_bytes_in_use": peak}
    return out


def battery_phase() -> dict:
    """The conformance battery on the device; prints the [V,D]=eig route."""
    from runmat_tpu import device_battery
    from runmat_tpu.accel import active_engine
    from runmat_tpu.session import Session
    sess = Session(accelerate=True)
    eng = active_engine()
    n_checks = sum(len(c[2]) for c in device_battery.CASES)
    res = device_battery.run(sess)
    for f in res["failures"]:
        say(f"  FAIL {f}")
    say(f"  battery: {res['passed']}/{n_checks} passed, {res['failed']} "
        f"failed, {res['cases']} cases")
    # which route [V,D] = eig took: the device program or a host fallback
    src = dict((n, s) for n, s, _ in device_battery.CASES)["eig_vd_device"]
    eng.launch_log.clear()
    f0 = eng.stats["host_fallbacks"]
    sess.execute(src)
    ops = [op for e in eng.launch_log for op in e["ops"]]
    route = "device eig_full" if "eig_full" in ops and \
        eng.stats["host_fallbacks"] == f0 else "host LAPACK"
    say(f"  [V,D]=eig route: {route} (linalg ops {sorted(set(ops))}, "
        f"host_fallbacks +{eng.stats['host_fallbacks'] - f0})")
    check(res["failed"] == 0 and res["passed"] == n_checks,
          f"battery: {res['failed']} failed")
    return {"passed": res["passed"], "checks": n_checks, "eig_route": route}


def _dot_lowering(f, *args) -> list:
    """Precision/algorithm descriptors of the dots in f's compiled HLO."""
    txt = f.lower(*args).compile().as_text()
    pats = (r'operand_precision=\{[^}]*\}', r'"operand_precision":\[[^\]]*\]',
            r'algorithm=[a-z0-9_]+', r'"algorithm":"[A-Za-z0-9_]+"',
            r'custom_call_target="[^"]+"', r'"kind":"__triton[a-z_]*"')
    return sorted({m for p in pats for m in re.findall(p, txt)})


def precision_phase(sizes=(512, 8192), policy_n: int = 512) -> dict:
    """`single` GEMM through the MATLAB surface against a float64 product,
    and what each matmul policy compiles to."""
    import jax
    import jax.numpy as jnp
    from runmat_tpu.accel import active_engine
    from runmat_tpu.session import Session
    from runmat_tpu.values import MatArray
    sess = Session(accelerate=True)
    eng = active_engine()
    rng = np.random.default_rng(1)
    out = {}

    def gemm_maxrel(n: int) -> float:
        a = rng.random((n, n), dtype=np.float32) - 0.5
        b = rng.random((n, n), dtype=np.float32) - 0.5
        sess.set("pA", MatArray(a, "single"))
        sess.set("pB", MatArray(b, "single"))
        sess.run_source("pC = gather(gpuArray(pA) * gpuArray(pB));", "gemm")
        got = sess.get("pC").host()
        sess.run_source("clear pA pB pC", "clear")
        return _maxrel(got, a.astype(np.float64) @ b.astype(np.float64))

    default = eng.matmul_precision
    for n in sizes:
        out[f"maxrel_{n}"] = gemm_maxrel(n)
        say(f"  single GEMM n={n}, policy {default}: maxrel vs float64 "
            f"{out[f'maxrel_{n}']:.3e}")
    check(out[f"maxrel_{sizes[0]}"] < 1e-4,
          f"single GEMM n={sizes[0]} maxrel {out[f'maxrel_{sizes[0]}']:.3e} "
          f">= 1e-4: reduced-precision products under the default policy")
    a = jax.device_put(np.ones((policy_n, policy_n), np.float32), eng.device)
    try:
        for pol in ("highest", "high", "bf16"):
            eng.matmul_precision = pol
            prec = eng.mm_precision()
            f = jax.jit(lambda x, y, p=prec: jnp.matmul(x, y, precision=p))
            desc = _dot_lowering(f, a, a)
            rel = gemm_maxrel(policy_n)
            out[pol] = {"precision": str(prec), "lowering": desc,
                        "maxrel": rel}
            say(f"  policy {pol}: {prec}, maxrel n={policy_n} {rel:.3e}, "
                f"compiled as {desc}")
    finally:
        eng.matmul_precision = default
    return out


def decisions_phase(gemm_sizes=(1024, 2048, 4096), hist_n: int = 50_000_000,
                    hist_bins: int = 64, reps: int = 5) -> dict:
    """Timed comparisons that decide what stays: native f64 GEMM against
    the Ozaki scheme, and the plain histcounts against a copy."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from runmat_tpu.accel import active_engine, ozaki
    from runmat_tpu.accel.dense import _b_histcounts
    from runmat_tpu.session import Session
    Session(accelerate=True)
    eng = active_engine()
    rng = np.random.default_rng(2)
    out = {"gemm_f64": {}}
    native = jax.jit(lambda x, y: jnp.matmul(
        x, y, precision=lax.Precision.HIGHEST))
    oz = jax.jit(lambda x, y: ozaki.gemm_f64(jnp, x, y))
    for n in gemm_sizes:
        A = rng.standard_normal((n, n))
        B = rng.standard_normal((n, n))
        ref = A @ B
        a = jax.device_put(A, eng.device)
        b = jax.device_put(B, eng.device)
        row = {}
        for label, fn in (("native", native), ("ozaki", oz)):
            rel = _maxrel(np.asarray(fn(a, b)), ref)   # compiles first
            ms = _median_ms(lambda: fn(a, b).block_until_ready(), reps)
            row[label] = {"ms": ms, "tflops": 2.0 * n ** 3 / ms / 1e9,
                          "maxrel": rel}
            say(f"  f64 GEMM n={n} {label}: {ms:.3f} ms, "
                f"{row[label]['tflops']:.2f} TFLOP/s, maxrel vs host "
                f"{rel:.2e}")
        out["gemm_f64"][n] = row
    x_h = rng.random(hist_n, dtype=np.float32)
    e_h = np.linspace(0.0, 1.0, hist_bins + 1).astype(np.float32)
    x = jax.device_put(x_h, eng.device)
    e = jax.device_put(e_h, eng.device)
    hist = jax.jit(_b_histcounts(eng, ()))
    counts = np.asarray(hist(x, e))
    want = np.histogram(x_h, bins=e_h)[0]
    ms = _median_ms(lambda: hist(x, e).block_until_ready(), reps)
    copy = jax.jit(lambda v: v * np.float32(2.0))
    copy(x).block_until_ready()
    ms_copy = _median_ms(lambda: copy(x).block_until_ready(), reps)
    out["histcounts"] = {"ms": ms, "gbps": 4.0 * hist_n / ms / 1e6,
                         "copy_ms": ms_copy,
                         "copy_gbps": 8.0 * hist_n / ms_copy / 1e6,
                         "exact": bool(np.array_equal(counts, want))}
    h = out["histcounts"]
    say(f"  histcounts N={hist_n} B={hist_bins}: {ms:.3f} ms, "
        f"{h['gbps']:.1f} GB/s of input; copy (read+write) {ms_copy:.3f} ms, "
        f"{h['copy_gbps']:.1f} GB/s; counts exact: {h['exact']}")
    check(h["exact"], "histcounts differs from np.histogram")
    return out


def mesh_phase(n_devices: int = 4, platform: str = None,
               paths: int = 1_000_000, steps: int = 256, gemm_n: int = 8192,
               fft_n: int = 1 << 20, unique_n: int = 1 << 22,
               solve_n: int = 4096) -> dict:
    """The engine mesh on `n_devices` devices: dp Monte-Carlo and a 2x2
    GEMM against one device, and a sharded op sweep against the host.
    `platform` pins the backend (the rehearsal on virtual CPU devices)."""
    from runmat_tpu.accel import init_engine, reset_engine
    from runmat_tpu.session import Session
    from runmat_tpu.values import MatArray
    out = {}

    def engine(mesh=None):
        reset_engine()
        eng = init_engine(platform=platform, required=True,
                          mesh_devices=mesh, auto_offload=True)
        if mesh is not None:
            check(eng.mesh is not None and eng.mesh.devices.size == n_devices,
                  f"mesh {mesh} not built over {n_devices} devices")
        return eng, Session(accelerate=True)

    def spec(eng, sess, var):
        v = sess.get(var)
        check(v.on_device, f"{var} is not on the device")
        return tuple(eng.materialize(v.dev).sharding.spec)

    # -- dp Monte-Carlo: the benchmark script on one card, then sharded
    mc = {"M": paths, "T": steps}
    eng, sess = engine()
    _run_script(sess, "monte_carlo", mc)
    p1 = _scalar(sess, "price")
    del sess
    eng, sess = engine(n_devices)
    eng.shard_threshold = min(eng.shard_threshold, paths // n_devices)
    _run_script(sess, "monte_carlo", mc)
    p_spec = spec(eng, sess, "S")
    p2 = _scalar(sess, "price")
    del sess
    rel = abs(p2 - p1) / abs(p1)
    say(f"  monte_carlo dp={n_devices} M={paths} T={steps}: price {p2!r} vs "
        f"one card {p1!r}, rel diff {rel:.3e}; S sharding {p_spec}")
    check(p_spec[:1] == ("data",), f"paths not sharded: {p_spec}")
    check(rel <= 1e-5, "dp Monte-Carlo price differs from one card")
    out["monte_carlo"] = {"rel_diff": rel, "spec": p_spec}

    # -- 2x2 ('data','model') sharded f64 GEMM against one card
    rng = np.random.default_rng(3)
    A = rng.standard_normal((gemm_n, gemm_n))
    B = rng.standard_normal((gemm_n, gemm_n))
    gemm = "Ad = distributed(A); Bd = distributed(B); C = gather(Ad * Bd);"
    dp = 2 if n_devices % 2 == 0 else 1
    eng, sess = engine((dp, n_devices // dp))
    sess.set("A", MatArray(A, "double"))
    sess.set("B", MatArray(B, "double"))
    sess.run_source(gemm, "gemm2d")
    specs = (spec(eng, sess, "Ad"), spec(eng, sess, "Bd"))
    C = sess.get("C").host()
    del sess
    eng, sess = engine()
    sess.set("A", MatArray(A, "double"))
    sess.set("B", MatArray(B, "double"))
    sess.run_source("C = gather(gpuArray(A) * gpuArray(B));", "gemm1")
    rel = _maxrel(C, sess.get("C").host())
    del sess
    say(f"  f64 GEMM {gemm_n}^2 on a {dp}x{n_devices // dp} mesh: maxrel vs "
        f"one card {rel:.3e}; operand shardings {specs}")
    check(specs == (("data", "model"),) * 2, f"GEMM operands {specs}")
    check(rel <= 1e-12, "sharded GEMM differs from one card")
    out["gemm"] = {"maxrel": rel, "specs": specs}

    # -- sharded op sweep against the host: FFT and cumsum along the sharded
    # axis, unique of a sharded vector, mldivide with a sharded right side
    F = rng.standard_normal((fft_n, 8))
    U = np.concatenate([rng.integers(0, 1000, unique_n - 3).astype(
        np.float64), [7.0, 7.0, 3.0]]).reshape(-1, 1)
    An = rng.standard_normal((solve_n, solve_n)) + np.eye(solve_n) * solve_n
    Bn = rng.standard_normal((solve_n, 64))
    eng, sess = engine((dp, n_devices // dp))
    for k, v in (("F", F), ("U", U), ("An", An), ("Bn", Bn)):
        sess.set(k, MatArray(v, "double"))
    sess.run_source(
        "Fd = distributed(F); ff = gather(abs(fft(Fd, [], 1))); "
        "cs = gather(cumsum(Fd, 1)); "
        "Ud = distributed(U); uu = gather(unique(Ud)); "
        "Bd = distributed(Bn); xx = gather(An \\ Bd);", "sweep")
    specs = {v: spec(eng, sess, v) for v in ("Fd", "Ud", "Bd")}
    errs = {
        "fft": _maxrel(sess.get("ff").host(), np.abs(np.fft.fft(F, axis=0))),
        "cumsum": _maxrel(sess.get("cs").host(), F.cumsum(0)),
        "unique": float(not np.array_equal(
            sess.get("uu").host().ravel(), np.unique(U))),
        "mldivide": _maxrel(sess.get("xx").host(), np.linalg.solve(An, Bn)),
    }
    del sess
    reset_engine()
    say(f"  sharded sweep: maxrel {errs}; shardings {specs}")
    check(all(s[:1] == ("data",) for s in specs.values()),
          f"sweep operands not sharded: {specs}")
    check(errs["fft"] <= 1e-12 and errs["cumsum"] <= 1e-12
          and errs["unique"] == 0 and errs["mldivide"] <= 1e-10,
          f"sharded sweep parity {errs}")
    out["sweep"] = {"maxrel": errs, "specs": specs}
    return out


# ----------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh phase, on four cards")
    args = ap.parse_args(argv)
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX sees {devices[0].platform})",
              file=sys.stderr)
        return 2
    if args.four_cards and len(devices) < 4:
        print(f"chip_smoke: --four-cards needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    device_phase()
    if args.four_cards:
        phases = (("mesh", mesh_phase),)
    else:
        phases = (("main path", main_path_phase), ("battery", battery_phase),
                  ("precision", precision_phase),
                  ("decisions", decisions_phase))
    failed = []
    for name, fn in phases:
        say(f"== {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            failed.append(name)
            traceback.print_exc()
            say(f"  {name}: FAILED")
        say(f"  ({time.perf_counter() - t0:.1f} s)")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    d = jax.devices()
    say(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
