"""Labelled nodes whose loss the window's steps took, a second of the
window (host clock from a synchronised start to the synchronised end)."""


def read(ctx):
    if not ctx.steps:
        return None
    return ctx.steps * ctx.counts["labelled"] / ctx.window_s
