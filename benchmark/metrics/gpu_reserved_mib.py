"""gpu_reserved_mib: `torch.cuda.memory_reserved()` at the end of the
window, in MiB: the card memory an application that embeds the renderer
gives up to it (its programs' pools and the allocator's cache)."""


def read(ctx):
    return ctx["reserved_bytes"] / 2 ** 20
