"""Share of the prefill programs' token rows that is padding, in %: each
batched prefill runs ``rows`` x ``bucket`` tokens for its real prompts'
``lengths`` (``engine.prefill``), over the iterations that started in the
measured window before the profiler (``perfbench/spans.py``)."""

from perfbench.spans import iterations


def read(run):
    its = iterations(run)
    if its is None:
        return None
    progs = [s["extra"] for it in its for s in it.get("engine.prefill", ())]
    run_tokens = sum(p["rows"] * p["bucket"] for p in progs)
    real = sum(sum(p["lengths"]) for p in progs)
    return 100.0 * (run_tokens - real) / run_tokens if run_tokens else None
