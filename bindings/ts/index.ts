/**
 * runmat-tpu TypeScript host bindings.
 *
 * Reference parity: the reference's npm `runmat` package
 * (bindings/ts/src/index.ts over the wasm session API,
 * crates/runmat-wasm/src/api/{init,session}.rs). One typed session surface
 * over three interchangeable transports, all speaking the same JSON op
 * protocol (runmat_tpu/server.py handle_request):
 *
 *  - createLocalSession()        browser: Pyodide + the pure-Python client
 *                                wheel (runmat_tpu/client.py, jax-free) —
 *                                MATLAB executes entirely client-side;
 *                                node: falls back to a subprocess running
 *                                `python -m runmat_tpu.client` (same
 *                                host-only engine profile)
 *  - connect(url, token)         remote accelerator server over HTTP (POST /api)
 *  - new RunMatSession()         local subprocess with the full accelerator engine
 */

import { spawn, ChildProcess } from "node:child_process";
import { createInterface, Interface } from "node:readline";

export interface ExecuteResult {
  ok: boolean;
  output?: string;
  wallMs?: number;
  error?: { identifier: string; message: string };
}

/** One ordered console chunk from the typed execution protocol. */
export interface StreamEntry {
  kind: "stdout" | "stderr";
  text: string;
  t_ms: number;
}

/** A value display event (unsuppressed expression / disp). */
export interface DisplayEvent {
  label: string;
  class: string;
  size?: number[];
  on_device?: boolean;
  preview?: string;
}

export interface WorkspaceUpsert {
  name: string;
  class: string;
  size?: number[];
  on_device?: boolean;
  bytes?: number;
  device_bytes?: number;
  preview?: string;
}

export interface ExecutionError {
  identifier: string;
  message: string;
  stack?: { name: string; line: number }[];
}

/**
 * Typed execution outcome (the execute_request ABI): ordered stdout/stderr
 * streams, display events, a workspace delta, structured warnings, touched
 * figures, and acceleration-engine dispatch deltas for the run.
 */
export interface ExecutionOutcome {
  ok: boolean;
  error?: ExecutionError | null;
  streams: StreamEntry[];
  display_events: DisplayEvent[];
  workspace_delta: { upserts: WorkspaceUpsert[]; removals: string[] };
  warnings: { identifier: string; message: string }[];
  figures_touched: number[];
  wall_ms: number;
  engine?: Record<string, number> | null;
}

export interface ValuePreview {
  class: string;
  size?: number[];
  value?: unknown;
  on_device?: boolean;
}

export interface AccelInfo {
  available: boolean;
  platform?: string;
  stats?: Record<string, number>;
}

export interface FusionPlan {
  kind: string;
  ops: string[];
  n_ops: number;
  n_outputs?: number;
}

export interface HoverCard extends ValuePreview {
  name: string;
  preview?: string;
  device_bytes?: number;
}

export interface BuiltinEntry {
  name: string;
  category: string;
  summary: string;
  min_in: number;
  max_in: number | null;
  max_out: number;
  /** has a device (GPU) fast path via the accel engine */
  accel: boolean;
  /** output must be gathered to host (e.g. disp) */
  sink: boolean;
  /** RunMat extension, hidden under strict-MATLAB compat */
  extension: boolean;
}

/**
 * Typed MATLAB error (≙ the reference npm package's error mapping):
 * `identifier` is the MATLAB identifier ("MATLAB:badsubscript", ...),
 * `kind` buckets the identifier family for programmatic handling.
 */
export class RunMatError extends Error {
  readonly identifier: string;
  readonly kind: "syntax" | "undefined" | "type" | "index" | "io" | "gpu" | "other";

  constructor(identifier: string, message: string) {
    super(`${identifier}: ${message}`);
    this.name = "RunMatError";
    this.identifier = identifier;
    this.kind = RunMatError.classify(identifier);
  }

  static classify(id: string): RunMatError["kind"] {
    if (/parse|syntax|Lexer/i.test(id)) return "syntax";
    if (/UndefinedFunction|UndefinedVariable/i.test(id)) return "undefined";
    if (/invalidType|NonNumeric|sizeDimensions|innerdim/i.test(id)) return "type";
    if (/badsubscript|IndexOutOfBounds/i.test(id)) return "index";
    if (/FileIO|NoSuchFile/i.test(id)) return "io";
    if (/gpu|parallel/i.test(id)) return "gpu";
    return "other";
  }
}

export interface Finding {
  line: number;
  severity: "error" | "warning" | "info";
  identifier: string;
  message: string;
}

interface Pending {
  resolve: (v: any) => void;
  reject: (e: Error) => void;
}

/**
 * A transport delivers one protocol request object and resolves with the
 * response object. All three transports speak the identical op surface
 * (server.py handle_request ≙ client.py handle_json).
 */
export interface Transport {
  send(body: Record<string, unknown>): Promise<any>;
  close(): Promise<void>;
}

/** Child process speaking JSON-lines on stdio (node hosts). */
export class SubprocessTransport implements Transport {
  private proc: ChildProcess;
  private rl: Interface;
  private nextId = 1;
  private pending = new Map<number, Pending>();

  constructor(args: string[], options: { python?: string; cwd?: string; env?: Record<string, string> } = {}) {
    const python = options.python ?? "python";
    this.proc = spawn(python, args, {
      cwd: options.cwd,
      env: { ...process.env, ...options.env },
      stdio: ["pipe", "pipe", "inherit"],
    });
    this.rl = createInterface({ input: this.proc.stdout! });
    this.rl.on("line", (line) => {
      let msg: any;
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

  send(body: Record<string, unknown>): Promise<any> {
    const id = this.nextId++;
    return new Promise((resolve, reject) => {
      this.pending.set(id, { resolve, reject });
      this.proc.stdin!.write(JSON.stringify({ id, ...body }) + "\n");
    });
  }

  async close(): Promise<void> {
    await this.send({ op: "shutdown" });
    this.proc.kill();
  }
}

/** HTTP transport to a running accelerator web server (POST /api + token auth). */
export class HttpTransport implements Transport {
  private nextId = 1;

  constructor(private url: string, private token: string) {
    this.url = url.replace(/\/$/, "");
  }

  async send(body: Record<string, unknown>): Promise<any> {
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

  async close(): Promise<void> {}
}

/**
 * In-browser transport: Pyodide running the pure-Python client wheel.
 * MATLAB executes entirely client-side with the numpy host provider —
 * no server, no jax (≙ runmat-wasm in-browser engine, api/init.rs).
 *
 * `pyodide` is a loaded Pyodide instance (the host calls loadPyodide());
 * `wheelUrl` points at the runmat_tpu_client wheel built by
 * scripts/build_client_wheel.py.
 */
export class PyodideTransport implements Transport {
  private ready: Promise<void>;
  private nextId = 1;

  constructor(private pyodide: any, wheelUrl: string) {
    this.ready = (async () => {
      await pyodide.loadPackage(["numpy", "micropip"]);
      const micropip = pyodide.pyimport("micropip");
      await micropip.install(wheelUrl);
      pyodide.runPython("from runmat_tpu import client as _rm_client");
    })();
  }

  async send(body: Record<string, unknown>): Promise<any> {
    await this.ready;
    const line = JSON.stringify({ id: this.nextId++, ...body });
    const handle = this.pyodide.globals.get("_rm_client").handle_json(line);
    return JSON.parse(String(handle));
  }

  async close(): Promise<void> {}
}

export class RunMatSession {
  protected transport: Transport;

  constructor(options: { python?: string; cwd?: string; env?: Record<string, string>; transport?: Transport } = {}) {
    this.transport =
      options.transport ??
      new SubprocessTransport(["-m", "runmat_tpu.cli", "serve"], options);
  }

  private request(body: Record<string, unknown>): Promise<any> {
    return this.transport.send(body);
  }

  /** Execute MATLAB source in the persistent workspace. */
  async execute(source: string, name = "<ts>"): Promise<ExecuteResult> {
    const r = await this.request({ op: "execute", source, name });
    return { ok: r.ok, output: r.output, wallMs: r.wall_ms, error: r.error };
  }

  /**
   * Execute with the typed event protocol: ordered streams, display
   * events, workspace delta, warnings, figures touched, engine deltas.
   */
  async executeAbi(source: string, name = "<ts>"): Promise<ExecutionOutcome> {
    const r = await this.request({ op: "execute_abi", source, name });
    return r as ExecutionOutcome;
  }

  /** Like execute(), but throws a typed RunMatError on failure. */
  async run(source: string, name = "<ts>"): Promise<string> {
    const r = await this.execute(source, name);
    if (!r.ok && r.error) throw new RunMatError(r.error.identifier, r.error.message);
    return r.output ?? "";
  }

  /** Workspace variable names with shape/class previews. */
  async workspace(): Promise<Record<string, ValuePreview>> {
    const r = await this.request({ op: "workspace" });
    return r.workspace ?? {};
  }

  /** Full value of one variable (numeric arrays as nested JS arrays). */
  async getValue(varName: string): Promise<ValuePreview> {
    const r = await this.request({ op: "get", name: varName });
    if (!r.ok) throw new RunMatError(r.error.identifier, r.error.message);
    return r.value;
  }

  /** Accelerator provider telemetry snapshot. */
  async accelInfo(): Promise<AccelInfo> {
    const r = await this.request({ op: "accel_info" });
    return r.accel;
  }

  /**
   * Cached fused-kernel plans (≙ the reference npm package's fusion-plan
   * introspection, bindings/ts/src/fusion-plan.ts): op sequence + output
   * count per compiled executable.
   */
  async fusionPlans(): Promise<FusionPlan[]> {
    const r = await this.request({ op: "fusion_plans" });
    return r.plans ?? [];
  }

  /**
   * Hover card for one workspace variable (≙ workspace-hover.ts):
   * class/shape/residency, short formatted preview, live HBM bytes.
   */
  async hover(varName: string): Promise<HoverCard> {
    const r = await this.request({ op: "hover", name: varName });
    if (!r.ok) throw new RunMatError(r.error.identifier, r.error.message);
    return r.hover;
  }

  /** Registered builtin catalog, optionally filtered (≙ builtins.ts). */
  async builtins(query = ""): Promise<BuiltinEntry[]> {
    const r = await this.request({ op: "builtins", query });
    return r.builtins ?? [];
  }

  /** Static-analysis findings for a source string (editor diagnostics). */
  async check(source: string, name = "<ts>"): Promise<Finding[]> {
    const r = await this.request({ op: "check", source, name });
    return r.findings ?? [];
  }

  /** Full telemetry snapshot: provider stats, HBM residency, launches. */
  async telemetry(): Promise<Record<string, unknown>> {
    const r = await this.request({ op: "telemetry" });
    return r.telemetry ?? {};
  }

  /** Clear the workspace. */
  async reset(): Promise<void> {
    await this.request({ op: "reset" });
  }

  /** Shut the session down (kills the child process if there is one). */
  async close(): Promise<void> {
    await this.transport.close();
  }
}

/**
 * Client-side session: MATLAB executes in the host process, no accelerator
 * server involved (≙ the reference npm package's default in-browser
 * mode). In a browser pass a Pyodide instance + wheel URL; in node the
 * fallback is a subprocess running the jax-free client profile
 * (`python -m runmat_tpu.client`).
 */
export function createLocalSession(
  options: {
    pyodide?: any;
    wheelUrl?: string;
    python?: string;
    cwd?: string;
  } = {},
): RunMatSession {
  if (options.pyodide) {
    const wheel = options.wheelUrl ?? "./runmat_tpu_client-0.4.0-py3-none-any.whl";
    return new RunMatSession({
      transport: new PyodideTransport(options.pyodide, wheel),
    });
  }
  return new RunMatSession({
    transport: new SubprocessTransport(["-m", "runmat_tpu.client"], options),
  });
}

/** Session against a running accelerator web server (`runmat-tpu serve --http`). */
export function connect(url: string, token: string): RunMatSession {
  return new RunMatSession({ transport: new HttpTransport(url, token) });
}

export default RunMatSession;
