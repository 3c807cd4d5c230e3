"""Milliseconds a decode tick: the engine loop's period from each decode
chunk's launch to the next one's, per tick, over the chunks launched in the
measured window before the profiler started (``readers.untraced_window``:
free of the profiler's cost to the host). Counting whole chunks of
``decode_chunk`` ticks against a window instead would step by a chunk: a
few seconds against a window of a few chunks."""

from perfbench.readers import untraced_window


def read(run):
    if run.trace is None or run.recorder is None:
        return None
    ns, ticks = run.recorder.loop_in(*untraced_window(run))
    return ns / 1e6 / ticks if ticks else None
