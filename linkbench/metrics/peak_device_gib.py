"""``peak_device_gib``: the most device memory the caching allocator held
for tensors during the window (``torch.cuda.max_memory_allocated`` after
a reset at the window's start), in GiB."""


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2**30
