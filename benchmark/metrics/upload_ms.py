"""upload_ms: mean host ms a traced frame in the renderer's
`prepare/upload` span (padding the words, stop table and atlas, their
content digests, pinning, and the host-to-device copies' enqueues)."""

from metrics._spans import prepare_part_ms


def read(ctx):
    return prepare_part_ms(ctx, "upload")
