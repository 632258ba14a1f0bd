"""frames_per_s: frames whose u8 surface reached the host, over the
window's seconds (from its start to the last frame's arrival)."""


def read(ctx):
    return ctx["frames_ok"] / ctx["window_s"]
