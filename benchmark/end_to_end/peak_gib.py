"""``peak_gib``: ``torch.cuda.max_memory_allocated`` over the window,
after a reset at its start, on the fullest card, in GiB."""


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2**30
