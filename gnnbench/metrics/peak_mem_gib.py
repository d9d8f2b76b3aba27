"""``torch.cuda.max_memory_allocated()`` over the program's set-up and the
window, in GiB (read after the window; the counter was reset once the
benchmark had generated its inputs)."""


def read(ctx):
    if ctx.peak_bytes is None:
        return None
    return ctx.peak_bytes / 2 ** 30
