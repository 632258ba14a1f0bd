"""Run one cell of the benchmark once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as the last line of
standard output (one JSON object: correct, attempted, failed, metrics,
device, with --trace 1 breakdown, and last the numbers compared with
their limits), and the set-up's parts and the same numbers as the last
lines of standard error. Exits non-zero, with no result, without a CUDA
card (or fewer than the cell asks for), when the program cannot be
imported, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Module names (the part before the first dot, compared whole) no run may
# load: JAX and the JAX package the program was ported from.
FORBIDDEN = ("jax", "jaxlib", "flax", "jello_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def prepare():
    """Every cache of the program and of torch inside the checkout, at
    fixed paths (the kernels build into jello_tpu_torch/_build/ of their
    own), and the checkout's root on the path."""
    cache = BENCH_DIR / "_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))
    for p in (str(ROOT), str(BENCH_DIR)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    prepare()
    from portbench import harness, spec

    chips = spec.workload(spec.load_benchmark(BENCH_DIR), args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: needs {chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                     "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: the run loaded {bad}; no run may load JAX or the JAX package",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
