"""Process self-inspection helpers behind the ``stack``/``memory`` debug
CLIs (reference: `ray stack` py-spy dumps + `ray memory` ref-count tables,
python/ray/scripts/scripts.py:2616). py-spy isn't in the image, so stacks
come from the interpreter itself (sys._current_frames) via a dump_stacks
RPC on every component."""

from __future__ import annotations

import sys
import threading
import traceback


def format_all_stacks() -> str:
    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        t = by_ident.get(ident)
        name = t.name if t else f"thread-{ident}"
        daemon = t.daemon if t else "?"
        out.append(f"--- {name} (daemon={daemon}) ---")
        out.append("".join(traceback.format_stack(frame)))
    out.append(format_asyncio_tasks())
    return "\n".join(out)


def format_asyncio_tasks() -> str:
    """Coroutine stacks of the CURRENT event loop's pending tasks — an
    async agent parks every coroutine in the selector, so thread dumps
    alone can't show where an RPC handler or pull is actually waiting."""
    import asyncio

    try:
        tasks = asyncio.all_tasks()
    except RuntimeError:  # no running loop in this thread
        return ""
    out = [f"--- asyncio tasks ({len(tasks)} pending) ---"]
    for task in tasks:
        try:
            stack = task.get_stack(limit=12)
            coro = getattr(task.get_coro(), "__qualname__", str(task))
            out.append(f"task {coro}:")
            for fr in stack:
                out.append("".join(traceback.format_stack(fr, limit=1)))
        except Exception:  # noqa: BLE001 - best-effort introspection
            continue
    return "\n".join(out)
