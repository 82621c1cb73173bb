"""torch.cuda.max_memory_allocated() over the window, GiB: card memory
that one stream of this traffic takes."""


def read(run):
    return run.window_peak_bytes / 2 ** 30
