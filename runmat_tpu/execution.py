"""Typed execution ABI: the structured per-run protocol for hosts.

Reference parity: runmat-core's `execute_request(ExecutionRequest) ->
ExecutionResponse` (crates/runmat-core/src/session/run.rs:330-385) and its
outcome record (crates/runmat-core/src/abi.rs:83-140 — ordered stdout/
stderr stream entries, display events, a workspace delta with upserts and
removals, structured diagnostics, figures touched, profiling). Hosts (web
REPL, TS client, LSP) consume this instead of scraping stdout text.

This runtime's twist: profiling carries the acceleration-engine dispatch
deltas (compiles / cache hits / gathers / device-memory movement) for the
run, so a
host can tell a warm fused step from a cold compile — the information the
reference surfaces via ProviderTelemetry snapshots
(runmat-accelerate-api/src/lib.rs:1337-1376).

Everything is JSON-ready via ``to_dict()``; nothing here imports jax.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np


def value_meta(v, preview_lines: int = 8) -> dict:
    """class/shape/residency metadata + short preview for a value."""
    from .values import MatArray, class_name
    d: dict = {"class": class_name(v)}
    shape = getattr(v, "shape", None)
    if shape is not None:
        d["size"] = [int(s) for s in shape]
    if isinstance(v, MatArray):
        d["on_device"] = bool(v.on_device)
        if v.on_device and v.dev.value is not None:
            d["device_bytes"] = int(getattr(v.dev.value, "nbytes", 0) or 0)
        elif not v.on_device:
            h = v.host()
            d["bytes"] = int(getattr(h, "nbytes", 0) or 0)
    if isinstance(v, MatArray) and v.on_device:
        # NEVER gather for an implicit preview — formatting a device
        # array materializes it to host and strips residency, silently
        # breaking the lazy DAG after every execute (and costing a full
        # device->host transfer per updated workspace variable)
        shp = "x".join(str(int(s)) for s in (shape or ()))
        d["preview"] = f"[{shp} {class_name(v)} gpuArray]"
        return d
    try:
        from .utils.display import format_value
        text = format_value("", v)
        lines = [ln for ln in text.splitlines() if ln.strip()]
        d["preview"] = "\n".join(lines[:preview_lines])
    except Exception:
        pass
    return d


class StreamEntry:
    """One ordered console chunk (≙ ExecutionStreamEntry,
    runmat-core/src/execution/types.rs:58)."""

    __slots__ = ("kind", "text", "t_ms")

    def __init__(self, kind: str, text: str, t_ms: float):
        self.kind = kind            # 'stdout' | 'stderr'
        self.text = text
        self.t_ms = t_ms

    def to_dict(self) -> dict:
        return {"kind": self.kind, "text": self.text,
                "t_ms": round(self.t_ms, 3)}


class DisplayEvent:
    """A value display (unsuppressed expression / `disp`): the host can
    render these richly instead of re-parsing stdout (≙ DisplayEvent,
    abi.rs:201)."""

    __slots__ = ("label", "meta")

    def __init__(self, label: str, meta: dict):
        self.label = label          # binding name, or 'ans', or ''
        self.meta = meta

    def to_dict(self) -> dict:
        return {"label": self.label, **self.meta}


class WorkspaceDelta:
    """Bindings created/updated and removed by the run (≙ WorkspaceDelta,
    abi.rs:186 — upserts carry metadata, not values; hosts fetch values
    on demand via get/hover)."""

    __slots__ = ("upserts", "removals")

    def __init__(self, upserts: list, removals: list):
        self.upserts = upserts      # [{name, class, size, ...}]
        self.removals = removals    # [name]

    def to_dict(self) -> dict:
        return {"upserts": self.upserts, "removals": self.removals}


class ExecutionOutcome:
    """The full structured result of one execute (≙ ExecutionOutcome,
    abi.rs:83)."""

    __slots__ = ("ok", "error", "streams", "display_events",
                 "workspace_delta", "warnings", "figures_touched",
                 "wall_ms", "engine")

    def __init__(self):
        self.ok = True
        self.error: Optional[dict] = None     # identifier/message/stack
        self.streams: list = []               # [StreamEntry]
        self.display_events: list = []        # [DisplayEvent]
        self.workspace_delta = WorkspaceDelta([], [])
        self.warnings: list = []              # [{identifier, message}]
        self.figures_touched: list = []       # [figure numbers]
        self.wall_ms = 0.0
        self.engine: Optional[dict] = None    # dispatch-stat deltas

    @property
    def output(self) -> str:
        """Concatenated console text (legacy surface)."""
        return "".join(e.text for e in self.streams)

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "error": self.error,
            "streams": [e.to_dict() for e in self.streams],
            "display_events": [e.to_dict() for e in self.display_events],
            "workspace_delta": self.workspace_delta.to_dict(),
            "warnings": self.warnings,
            "figures_touched": self.figures_touched,
            "wall_ms": round(self.wall_ms, 3),
            "engine": self.engine,
        }


class Recorder:
    """Per-run event recorder installed on the session while an
    execute_request is active."""

    __slots__ = ("t0", "streams", "display_events", "warnings")

    def __init__(self):
        self.t0 = time.perf_counter()
        self.streams: list = []
        self.display_events: list = []
        self.warnings: list = []

    def now_ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1e3

    def on_write(self, text: str, kind: str = "stdout") -> None:
        # coalesce adjacent same-kind chunks so fprintf loops don't build
        # thousands of entries
        if self.streams and self.streams[-1].kind == kind and \
                len(self.streams[-1].text) < 65536:
            self.streams[-1].text += text
        else:
            self.streams.append(StreamEntry(kind, text, self.now_ms()))

    def on_display(self, label: str, value) -> None:
        try:
            self.display_events.append(DisplayEvent(label, value_meta(value)))
        except Exception:
            pass

    def on_warning(self, identifier: str, message: str) -> None:
        self.warnings.append({"identifier": identifier, "message": message})


def workspace_signature(vars_: dict) -> dict:
    """{name: identity} snapshot for delta computation. Values are
    immutable-by-COW in the VM, so object identity is a sound 'changed'
    signal."""
    return {k: id(v) for k, v in vars_.items() if not k.startswith("@")}


def workspace_delta(before: dict, vars_: dict) -> WorkspaceDelta:
    upserts = []
    for k, v in vars_.items():
        if k.startswith("@"):
            continue
        if before.get(k) != id(v):
            meta = value_meta(v, preview_lines=1)
            meta["name"] = k
            upserts.append(meta)
    removals = [k for k in before if k not in vars_]
    upserts.sort(key=lambda d: d["name"])
    return WorkspaceDelta(upserts, sorted(removals))
