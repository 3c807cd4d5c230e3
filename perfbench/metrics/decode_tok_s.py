"""Tokens a second: every token the engine produced in the window, each
request's tokens spread evenly between the host copies that brought them
(``stats.produced_between``), over the window's seconds."""

from perfbench.stats import produced_between


def read(run):
    streams = run.extra.get("streams")
    if not streams:
        return None
    w0, w1 = run.window
    return sum(produced_between(sent, copies, w0, w1) for sent, copies in streams) / run.window_s
