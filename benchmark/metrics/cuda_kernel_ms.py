"""cuda_kernel_ms: device ms a traced frame in the program's hand-written
kernels: every `__global__` function of its `csrc/*.cu` sources (read
from the program's package, so a kernel a later change adds counts too).
torch's own kernels and a CUDA graph's memset and memcpy nodes do not."""

import functools
import re
from pathlib import Path

from metrics._common import kernel_ms_per_frame

GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


@functools.cache
def hand_written() -> frozenset:
    import jello_tpu_torch

    csrc = Path(jello_tpu_torch.__file__).parent / "csrc"
    return frozenset(m.group(1) for p in sorted(csrc.glob("*.cu"))
                     for m in GLOBAL.finditer(p.read_text()))


def read(ctx):
    trace = ctx.get("trace")
    if not trace:
        return None
    names = hand_written()
    return kernel_ms_per_frame(trace, lambda kind: kind in names)
