"""peak_mem_gib: the device allocator's peak over set-up and window
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30
