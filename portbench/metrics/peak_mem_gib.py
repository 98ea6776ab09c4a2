"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the run up to the
window's close (set-up and window; not the reference after it), in GiB."""


def read(record):
    return record.peak_bytes / 2 ** 30 if record.peak_bytes else None
