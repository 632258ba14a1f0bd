"""Host-side renderer support: resolve, layout, ramp cache, estimation.

The port's own copy of `jello_tpu/renderer/__init__.py` (same text; only the imports
stay inside `jello_tpu_torch`), so that the port imports nothing of
`jello_tpu`.
"""
