"""Runtime environments: per-task/actor env_vars + working_dir.

Reference capability: python/ray/_private/runtime_env/ (runtime_env_agent +
working_dir/pip/conda plugins); own copy of ray_tpu.core.runtime_env.
Redesign for a zero-egress fleet:

- ``env_vars``: merged into a DEDICATED worker's process environment; the
  worker pool is keyed by the runtime-env hash, so workers are reused within
  an env and never shared across envs (reference: worker pool env isolation);
- ``working_dir``: a local directory, packaged (zip) by the submitting
  driver into GCS KV once per content hash; every agent stages it into its
  session dir and runs the worker with cwd + sys.path there — code ships to
  nodes without a shared filesystem;
- ``pip``/``conda``: rejected with a clear error — this framework targets
  hermetic images with zero egress (installing at task time is exactly
  what the fleet design forbids). The key is VALIDATED, not ignored.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import zipfile
from typing import Any, Dict, Optional, Tuple

MAX_PACKAGE_BYTES = 64 * 1024 * 1024
SUPPORTED_KEYS = {"env_vars", "working_dir", "py_modules"}
REJECTED_KEYS = {"pip", "conda", "container", "py_executable"}


def normalize(runtime_env: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Strip internal keys, validate, canonicalize. Raises on unsupported
    install-at-runtime requests."""
    # every "__"-prefixed key is framework-internal plumbing (actor names,
    # trace context, ...): stripped here, re-merged verbatim by
    # cluster_runtime._prepare_runtime_env
    env = {k: v for k, v in (runtime_env or {}).items()
           if not k.startswith("__")}
    if not env:
        return {}
    bad = set(env) & REJECTED_KEYS
    if bad:
        raise ValueError(
            f"runtime_env keys {sorted(bad)} are not supported: this "
            "framework targets hermetic zero-egress images (bake "
            "dependencies into the image; use working_dir/env_vars for code "
            "and configuration)"
        )
    unknown = set(env) - SUPPORTED_KEYS
    if unknown:
        raise ValueError(f"unknown runtime_env keys {sorted(unknown)}; "
                         f"supported: {sorted(SUPPORTED_KEYS)}")
    if "env_vars" in env:
        ev = env["env_vars"]
        if not isinstance(ev, dict) or not all(
            isinstance(k, str) and isinstance(v, str) for k, v in ev.items()
        ):
            raise ValueError("runtime_env env_vars must be Dict[str, str]")
    if "py_modules" in env:
        pm = env["py_modules"]
        if not isinstance(pm, (list, tuple)) or not all(
            isinstance(p, str) for p in pm
        ):
            raise ValueError(
                "runtime_env py_modules must be a list of local paths "
                "(module directories or single .py files)")
        env["py_modules"] = list(pm)
    return env


def env_hash(env: Dict[str, Any]) -> str:
    if not env:
        return ""
    return hashlib.sha1(
        json.dumps(env, sort_keys=True).encode()
    ).hexdigest()[:16]


# ------------------------------------------------------------- working_dir
def _zip_tree(zf: "zipfile.ZipFile", path: str, arc_prefix: str,
              label: str, total: int = 0) -> int:
    """Deterministic tree zipper shared by every packager: sorted walk,
    cache/VCS exclusions, fixed ZipInfo metadata (identical trees hash
    identically), and the MAX_PACKAGE_BYTES budget. Returns running total."""
    for root, dirs, files in sorted(os.walk(path)):
        dirs[:] = sorted(d for d in dirs
                         if d not in ("__pycache__", ".git", ".venv"))
        for name in sorted(files):
            if name.endswith((".pyc", ".pyo")):
                continue
            full = os.path.join(root, name)
            rel = os.path.join(arc_prefix, os.path.relpath(full, path)) \
                if arc_prefix else os.path.relpath(full, path)
            total += os.path.getsize(full)
            if total > MAX_PACKAGE_BYTES:
                raise ValueError(
                    f"{label} {path!r} exceeds "
                    f"{MAX_PACKAGE_BYTES >> 20}MB packaged")
            zi = zipfile.ZipInfo(rel)  # fixed metadata: deterministic hash
            with open(full, "rb") as f:
                zf.writestr(zi, f.read())
    return total


def package_working_dir(path: str) -> Tuple[str, bytes]:
    """Zip a local directory -> (content_hash, payload). Deterministic
    ordering so identical trees share one KV entry."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise ValueError(f"working_dir {path!r} is not a directory")
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        _zip_tree(zf, path, "", "working_dir")
    payload = buf.getvalue()
    return hashlib.sha1(payload).hexdigest()[:16], payload


def package_py_module(path: str) -> Tuple[str, bytes]:
    """Zip ONE python module (a package directory, zipped under its own
    basename so the staged root is PYTHONPATH-able, or a single .py file)
    -> (content_hash, payload). Reference: runtime_env py_modules plugin."""
    path = os.path.abspath(path.rstrip("/"))
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        if os.path.isfile(path):
            if not path.endswith(".py"):
                raise ValueError(f"py_modules file {path!r} must be a .py file")
            if os.path.getsize(path) > MAX_PACKAGE_BYTES:
                raise ValueError(
                    f"py_module {path!r} exceeds "
                    f"{MAX_PACKAGE_BYTES >> 20}MB packaged")
            zi = zipfile.ZipInfo(os.path.basename(path))
            with open(path, "rb") as f:
                zf.writestr(zi, f.read())
        elif os.path.isdir(path):
            _zip_tree(zf, path, os.path.basename(path), "py_module")
        else:
            raise ValueError(f"py_modules path {path!r} does not exist")
    payload = buf.getvalue()
    return hashlib.sha1(payload).hexdigest()[:16], payload


def kv_key(content_hash: str) -> str:
    return f"runtimeenv:{content_hash}"


def stage_package(payload: bytes, content_hash: str, session_dir: str) -> str:
    """Extract a working_dir package into the node session dir. Idempotent
    AND concurrency-safe: extraction happens in a private temp dir that is
    atomically renamed into place, so agents sharing a session dir never
    expose partially-written modules to workers."""
    import uuid

    base = os.path.join(session_dir, "runtime_envs")
    dest = os.path.join(base, content_hash)
    if os.path.isdir(dest):
        return dest
    os.makedirs(base, exist_ok=True)
    tmp = os.path.join(base, f".tmp-{content_hash}-{uuid.uuid4().hex[:8]}")
    os.makedirs(tmp)
    try:
        with zipfile.ZipFile(io.BytesIO(payload)) as zf:
            for info in zf.infolist():  # refuse absolute/.. escapes
                name = info.filename
                if name.startswith("/") or ".." in name.split("/"):
                    raise ValueError(f"unsafe path in working_dir package: {name!r}")
            zf.extractall(tmp)
        try:
            os.rename(tmp, dest)
        except OSError:
            pass  # another agent won the race; its copy is complete
    finally:
        if os.path.isdir(tmp):
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
    return dest
