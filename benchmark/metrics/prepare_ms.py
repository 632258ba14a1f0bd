"""prepare_ms: mean host ms a frame in the renderer's `prepare` span
(`Renderer.profiler`: resolve, layout, upload; about 0 when the same scene
is cached), over the traced frames."""


def read(ctx):
    calls = ctx.get("spans") or []
    ms = [c.duration * 1e3 for g in calls for c in g.children if c.label == "prepare"]
    return sum(ms) / len(ms) if ms else None
