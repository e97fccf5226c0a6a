"""peak_gib (GiB): torch's allocator peak on the card from handing the
inputs over to the end of the window (`torch.cuda.max_memory_allocated`,
read by the harness on the host)."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
