"""Layered configuration: runmat.toml / runmat.json + RUNMAT_CONFIG + env.

Reference parity: runmat-config (crates/runmat-config/src/runtime/{loader,
schema} — file discovery, per-domain schemas, env pointer RUNMAT_CONFIG,
CLI-flag override with provenance). Precedence: defaults < config file <
RUNMAT_TPU_* environment variables < explicit API arguments.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

_DEFAULTS: dict[str, dict[str, Any]] = {
    "accelerate": {
        "provider": "auto",          # auto | jax | none
        "platform": None,            # cpu | gpu | None (auto)
        "auto_offload": None,        # None = platform default
        "offload_threshold": 32768,
        "fuse_cap": None,
        # contraction precision for f32 operands: "highest" (plain f32,
        # MATLAB single parity — default), "high" and "bf16" (reduced-
        # precision products; "bf16" is lax.Precision.DEFAULT, TF32 on an
        # NVIDIA GPU), opt-in downcast ≙ RUNMAT_ALLOW_PRECISION_DOWNCAST,
        # reference precision.rs:31-60
        "matmul_precision": "highest",
        # Wall-budget (seconds) for replaying the warmup manifest at session
        # init via AOT lower().compile() — pre-populates the persistent XLA
        # cache before the first user program (≙ pipeline warmup from disk,
        # wgpu/warmup.rs:10). 0 disables (the default; bench/batch flows
        # opt in explicitly).
        "warmup_init_budget_s": 0,
    },
    "execution": {
        "seed": 0,
    },
    "language": {
        # "extended" (default): RunMat extensions (spawn/await, accelInfo,
        # ...) are available. "strict": pure MATLAB surface — extension
        # builtins resolve as undefined (≙ ParserOptions CompatMode,
        # runmat-parser/src/options.rs). Env: RUNMAT_TPU_COMPAT.
        "compat": "extended",
    },
    "logging": {
        "level": "warning",
        "trace": False,
    },
    "plotting": {
        "export_format": "svg",
    },
    "telemetry": {
        "enabled": False,            # consent-gated, local JSONL only
        "path": None,
    },
}

_FILENAMES = ("runmat.toml", "runmat.json")


def _find_config_file(start: Optional[str] = None) -> Optional[str]:
    env = os.environ.get("RUNMAT_CONFIG")
    if env:
        return env if os.path.exists(env) else None
    d = os.path.abspath(start or os.getcwd())
    while True:
        for name in _FILENAMES:
            p = os.path.join(d, name)
            if os.path.exists(p):
                return p
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


def _load_file(path: str) -> dict:
    with open(path, "rb") as f:
        if path.endswith(".toml"):
            import tomllib
            return tomllib.load(f)
        return json.load(f)


_ENV_MAP = {
    "RUNMAT_TPU_PLATFORM": ("accelerate", "platform", str),
    "RUNMAT_TPU_AUTO_OFFLOAD": ("accelerate", "auto_offload",
                                lambda v: v == "1"),
    "RUNMAT_TPU_OFFLOAD_THRESHOLD": ("accelerate", "offload_threshold", int),
    "RUNMAT_TPU_FUSE_CAP": ("accelerate", "fuse_cap", int),
    "RUNMAT_TPU_COMPAT": ("language", "compat", str),
    "RUNMAT_TPU_MATMUL_PRECISION": ("accelerate", "matmul_precision", str),
    "RUNMAT_TPU_WARMUP_INIT_BUDGET": ("accelerate", "warmup_init_budget_s",
                                      float),
    "RUNMAT_TPU_LOG": ("logging", "level", str),
    "RUNMAT_TPU_TRACE": ("logging", "trace", lambda v: v == "1"),
}


class Config:
    def __init__(self, data: dict, source: Optional[str]):
        self.data = data
        self.source = source            # provenance: file path or None
        self.overrides: list[str] = []  # env-var provenance

    def get(self, section: str, key: str, default=None):
        return self.data.get(section, {}).get(
            key, _DEFAULTS.get(section, {}).get(key, default))

    def describe(self) -> dict:
        return {"source": self.source or "<defaults>",
                "env_overrides": self.overrides,
                "data": self.data}


def load(start: Optional[str] = None) -> Config:
    data = {k: dict(v) for k, v in _DEFAULTS.items()}
    path = _find_config_file(start)
    if path:
        try:
            loaded = _load_file(path)
            for sect, vals in loaded.items():
                if isinstance(vals, dict):
                    data.setdefault(sect, {}).update(vals)
        except Exception:
            path = None
    cfg = Config(data, path)
    for env, (sect, key, conv) in _ENV_MAP.items():
        v = os.environ.get(env)
        if v is not None:
            try:
                data.setdefault(sect, {})[key] = conv(v)
                cfg.overrides.append(env)
            except (ValueError, TypeError):
                pass
    return cfg


def generate_default(path: str = "runmat.toml") -> str:
    lines = []
    for sect, vals in _DEFAULTS.items():
        lines.append(f"[{sect}]")
        for k, v in vals.items():
            if v is None:
                lines.append(f"# {k} =")
            elif isinstance(v, bool):
                lines.append(f"{k} = {'true' if v else 'false'}")
            elif isinstance(v, str):
                lines.append(f'{k} = "{v}"')
            else:
                lines.append(f"{k} = {v}")
        lines.append("")
    text = "\n".join(lines)
    with open(path, "w") as f:
        f.write(text)
    return path
