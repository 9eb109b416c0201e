/**
 * node:test suite for createLocalSession — the client-side engine
 * profile: MATLAB executes in `python -m runmat_tpu.client` with the
 * numpy host provider and NO jax / NO server (≙ the reference npm
 * package's in-browser wasm mode; in a browser the same RunMatSession
 * rides PyodideTransport + the wheel from scripts/build_client_wheel.py).
 */

import test from "node:test";
import assert from "node:assert/strict";
import { createLocalSession, connect, HttpTransport } from "../dist/index.js";

test("local session executes without the accelerator server", async () => {
  const s = createLocalSession();
  try {
    const r = await s.execute("x = cumsum(1:5); disp(max(x))");
    assert.equal(r.ok, true);
    assert.match(r.output ?? "", /15/);
    const ws = await s.workspace();
    assert.equal(ws.x.class, "double");
  } finally {
    await s.close();
  }
});

test("local session is jax-free (accel reports unavailable)", async () => {
  const s = createLocalSession();
  try {
    const info = await s.accelInfo();
    assert.equal(info.available, false);
  } finally {
    await s.close();
  }
});

test("local session renders figures client-side", async () => {
  const s = createLocalSession();
  try {
    await s.run("plot(sin(linspace(0, 6, 50)));");
    // figures op returns SVG rendered in-process, no server round trip
    const r = await s.transport.send({ op: "figures" });
    assert.equal(r.ok, true);
    assert.ok(r.figures.length >= 1);
    assert.match(r.figures[0].svg, /<svg/);
  } finally {
    await s.close();
  }
});

test("connect() builds an HTTP-transport session", () => {
  const s = connect("http://127.0.0.1:9999/", "tok");
  assert.ok(s.transport instanceof HttpTransport);
});
