#!/usr/bin/env python
"""Build the pure-Python client wheel for in-browser (Pyodide) embedding.

≙ reference runmat-wasm's wasm-pack build + regenerate-wasm-registry.sh
(crates/runmat-wasm/, scripts/regenerate-wasm-registry.sh): the artifact a
browser host loads to run MATLAB client-side. Here the front end is pure
Python, so the artifact is a py3-none-any wheel of the `runmat_tpu`
package that micropip can install into Pyodide (which ships numpy but not
jax — the client profile never imports jax; see runmat_tpu/client.py).

Usage: python scripts/build_client_wheel.py [outdir]   (default: dist/)

The wheel is assembled directly (zipfile + METADATA/WHEEL/RECORD) rather
than through pip so the build is hermetic and offline.
"""

from __future__ import annotations

import base64
import hashlib
import os
import sys
import zipfile

NAME = "runmat_tpu_client"
VERSION = "0.4.0"

EXCLUDE_DIRS = {"__pycache__"}
# Everything ships: accel/ imports jax only when an engine initializes,
# and the client profile never initializes one. Shipping the full tree
# keeps one import namespace for both profiles.


def _record_hash(data: bytes) -> str:
    return "sha256=" + base64.urlsafe_b64encode(
        hashlib.sha256(data).digest()).rstrip(b"=").decode()


def build(outdir: str) -> str:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(repo, "runmat_tpu")
    os.makedirs(outdir, exist_ok=True)
    tag = "py3-none-any"
    wheel_path = os.path.join(outdir, f"{NAME}-{VERSION}-{tag}.whl")
    distinfo = f"{NAME}-{VERSION}.dist-info"
    record_rows = []

    with zipfile.ZipFile(wheel_path, "w", zipfile.ZIP_DEFLATED) as zf:
        def add(arcname: str, data: bytes) -> None:
            zf.writestr(arcname, data)
            record_rows.append(
                f"{arcname},{_record_hash(data)},{len(data)}")

        for root, dirs, files in os.walk(pkg):
            dirs[:] = sorted(d for d in dirs if d not in EXCLUDE_DIRS)
            for fn in sorted(files):
                if not fn.endswith(".py"):
                    continue
                full = os.path.join(root, fn)
                rel = os.path.relpath(full, repo)
                with open(full, "rb") as f:
                    add(rel.replace(os.sep, "/"), f.read())

        add(f"{distinfo}/METADATA", (
            f"Metadata-Version: 2.1\nName: {NAME}\nVersion: {VERSION}\n"
            "Summary: RunMat language front end for client-side "
            "(Pyodide/browser) execution\n"
            "Requires-Dist: numpy\n").encode())
        add(f"{distinfo}/WHEEL", (
            "Wheel-Version: 1.0\nGenerator: build_client_wheel\n"
            f"Root-Is-Purelib: true\nTag: {tag}\n").encode())
        record = f"{distinfo}/RECORD"
        rows = "\n".join(record_rows + [f"{record},,"]) + "\n"
        zf.writestr(record, rows)
    return wheel_path


if __name__ == "__main__":
    out = build(sys.argv[1] if len(sys.argv) > 1 else "dist")
    print(out)
