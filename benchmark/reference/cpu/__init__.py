"""The path tag monoid of the oracle (jello_tpu/cpu/pathtag.py)."""
