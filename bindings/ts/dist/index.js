/**
 * runmat-tpu TypeScript host bindings — compiled ESM (type annotations
 * stripped from ../index.ts so the package runs without a TS toolchain;
 * index.ts remains the typed source of truth).
 */

import { spawn } from "node:child_process";
import { createInterface } from "node:readline";

export class RunMatError extends Error {
  constructor(identifier, message) {
    super(`${identifier}: ${message}`);
    this.name = "RunMatError";
    this.identifier = identifier;
    this.kind = RunMatError.classify(identifier);
  }

  static classify(id) {
    if (/parse|syntax|Lexer/i.test(id)) return "syntax";
    if (/UndefinedFunction|UndefinedVariable/i.test(id)) return "undefined";
    if (/invalidType|NonNumeric|sizeDimensions|innerdim/i.test(id)) return "type";
    if (/badsubscript|IndexOutOfBounds/i.test(id)) return "index";
    if (/FileIO|NoSuchFile/i.test(id)) return "io";
    if (/gpu|parallel/i.test(id)) return "gpu";
    return "other";
  }
}

/** Child process speaking JSON-lines on stdio (node hosts). */
export class SubprocessTransport {
  constructor(args, options = {}) {
    const python = options.python ?? "python";
    this.nextId = 1;
    this.pending = new Map();
    this.proc = spawn(python, args, {
      cwd: options.cwd,
      env: { ...process.env, ...options.env },
      stdio: ["pipe", "pipe", "inherit"],
    });
    this.rl = createInterface({ input: this.proc.stdout });
    this.rl.on("line", (line) => {
      let msg;
      try {
        msg = JSON.parse(line);
      } catch {
        return;
      }
      const p = this.pending.get(msg.id);
      if (p) {
        this.pending.delete(msg.id);
        p.resolve(msg);
      }
    });
  }

  send(body) {
    const id = this.nextId++;
    return new Promise((resolve, reject) => {
      this.pending.set(id, { resolve, reject });
      this.proc.stdin.write(JSON.stringify({ id, ...body }) + "\n");
    });
  }

  async close() {
    await this.send({ op: "shutdown" });
    this.proc.kill();
  }
}

/** HTTP transport to a running accelerator web server (POST /api + token auth). */
export class HttpTransport {
  constructor(url, token) {
    this.url = url.replace(/\/$/, "");
    this.token = token;
    this.nextId = 1;
  }

  async send(body) {
    const r = await fetch(`${this.url}/api`, {
      method: "POST",
      headers: {
        "Content-Type": "application/json",
        "X-Runmat-Token": this.token,
      },
      body: JSON.stringify({ id: this.nextId++, ...body }),
    });
    if (!r.ok) throw new RunMatError("RunMat:server:Http", `HTTP ${r.status}`);
    return r.json();
  }

  async close() {}
}

/**
 * In-browser transport: Pyodide running the pure-Python client wheel
 * (runmat_tpu/client.py, jax-free) — MATLAB executes entirely
 * client-side with the numpy host provider.
 */
export class PyodideTransport {
  constructor(pyodide, wheelUrl) {
    this.pyodide = pyodide;
    this.nextId = 1;
    this.ready = (async () => {
      await pyodide.loadPackage(["numpy", "micropip"]);
      const micropip = pyodide.pyimport("micropip");
      await micropip.install(wheelUrl);
      pyodide.runPython("from runmat_tpu import client as _rm_client");
    })();
  }

  async send(body) {
    await this.ready;
    const line = JSON.stringify({ id: this.nextId++, ...body });
    const handle = this.pyodide.globals.get("_rm_client").handle_json(line);
    return JSON.parse(String(handle));
  }

  async close() {}
}

export class RunMatSession {
  constructor(options = {}) {
    this.transport =
      options.transport ??
      new SubprocessTransport(["-m", "runmat_tpu.cli", "serve"], options);
  }

  request(body) {
    return this.transport.send(body);
  }

  async execute(source, name = "<ts>") {
    const r = await this.request({ op: "execute", source, name });
    return { ok: r.ok, output: r.output, wallMs: r.wall_ms, error: r.error };
  }

  async executeAbi(source, name = "<ts>") {
    const r = await this.request({ op: "execute_abi", source, name });
    return r;
  }

  async run(source, name = "<ts>") {
    const r = await this.execute(source, name);
    if (!r.ok && r.error) throw new RunMatError(r.error.identifier, r.error.message);
    return r.output ?? "";
  }

  async workspace() {
    const r = await this.request({ op: "workspace" });
    return r.workspace ?? {};
  }

  async getValue(varName) {
    const r = await this.request({ op: "get", name: varName });
    if (!r.ok) throw new RunMatError(r.error.identifier, r.error.message);
    return r.value;
  }

  async accelInfo() {
    const r = await this.request({ op: "accel_info" });
    return r.accel;
  }

  async fusionPlans() {
    const r = await this.request({ op: "fusion_plans" });
    return r.plans ?? [];
  }

  async hover(varName) {
    const r = await this.request({ op: "hover", name: varName });
    if (!r.ok) throw new RunMatError(r.error.identifier, r.error.message);
    return r.hover;
  }

  async builtins(query = "") {
    const r = await this.request({ op: "builtins", query });
    return r.builtins ?? [];
  }

  async check(source, name = "<ts>") {
    const r = await this.request({ op: "check", source, name });
    return r.findings ?? [];
  }

  async telemetry() {
    const r = await this.request({ op: "telemetry" });
    return r.telemetry ?? {};
  }

  async reset() {
    await this.request({ op: "reset" });
  }

  async close() {
    await this.transport.close();
  }
}

/**
 * Client-side session: MATLAB executes in the host process, no accelerator
 * server. Browser: pass { pyodide, wheelUrl }. Node: subprocess running
 * the jax-free client profile (`python -m runmat_tpu.client`).
 */
export function createLocalSession(options = {}) {
  if (options.pyodide) {
    const wheel =
      options.wheelUrl ?? "./runmat_tpu_client-0.4.0-py3-none-any.whl";
    return new RunMatSession({
      transport: new PyodideTransport(options.pyodide, wheel),
    });
  }
  return new RunMatSession({
    transport: new SubprocessTransport(["-m", "runmat_tpu.client"], options),
  });
}

/** Session against a running accelerator web server (`runmat-tpu serve --http`). */
export function connect(url, token) {
  return new RunMatSession({ transport: new HttpTransport(url, token) });
}

export default RunMatSession;
