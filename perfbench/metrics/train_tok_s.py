"""Tokens of every step completed in the window, over its seconds (the
window ends with a synchronising read of the loss)."""


def read(run):
    if not run.steps:
        return None
    return run.steps * run.tokens_per_step / run.window_s
