"""resolve_ms: mean host ms a traced frame in the renderer's
`prepare/resolve` span (`Resolver.resolve`: the scene's streams, ramps
and images laid out for the device)."""

from metrics._spans import prepare_part_ms


def read(ctx):
    return prepare_part_ms(ctx, "resolve")
