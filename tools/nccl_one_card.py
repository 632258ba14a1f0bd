#!/usr/bin/env python3
"""Ask NCCL for two ranks on one card, which `jello_tpu_torch.cuda.
collectives.run_ranks` refuses, and print what each rank's NCCL says.

    python3 tools/nccl_one_card.py

Each rank joins a two-rank NCCL group on cuda:0 and sums one tensor; a
rank that raises prints its exception and exits non-zero. The ranks get
120 s, then are stopped. Exits 0 whatever NCCL did: the output is the
finding.
"""

import multiprocessing
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _rank(rank, store):
    import torch

    from jello_tpu_torch.cuda.collectives import init_group, psum

    try:
        with init_group(rank, 2, "nccl", store, torch.device("cuda", 0)) as g:
            total = psum(g, torch.ones(4, device="cuda:0"))
            torch.cuda.synchronize()
            print(f"rank {rank}: psum on one card gave {total.tolist()}", flush=True)
    except Exception as e:
        print(f"rank {rank}: {type(e).__name__}: {e}", flush=True)
        raise


def main():
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank, args=(r, Path(d) / "store")) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(120)
        for r, p in enumerate(procs):
            if p.is_alive():
                p.kill()
                p.join()
                print(f"rank {r}: still running after 120 s, stopped")
            print(f"rank {r}: exit code {p.exitcode}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
