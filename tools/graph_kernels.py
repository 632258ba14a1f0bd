#!/usr/bin/env python3
"""The device operations of each gate config's settled frame program on
one NVIDIA GPU, read from its captured CUDA graph (chip_smoke's
`_graph_ops`), for the tree it is run from:

    python3 tools/graph_kernels.py [--configs 1,4] [--out DIR --tag NAME]

For each config a fresh Renderer(device="cuda") renders the scene three
times through `render_surface` (the class settles, the next render
builds the class's program), and the program's graph is read: kernels
and copies a frame. With `--out`, each config's {operation: nodes} goes
to DIR/NAME_configN.json. Run it from the roots of two trees in turns
(parent, change, change, parent) to compare their frames in one call.
Prints the card's name and power limit beside the counts.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import chip_smoke  # noqa: E402  (blocks JAX and jello_tpu; its graph reader)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="1,4")
    ap.add_argument("--out", default=None)
    ap.add_argument("--tag", default="tree")
    opts = ap.parse_args()

    from jello_tpu_torch.cuda import Renderer
    from jello_tpu_torch.scenes import GATE_SCENES

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    for c in (int(x) for x in opts.configs.split(",")):
        scene, params = GATE_SCENES[c]()
        r = Renderer(device="cuda")
        for _ in range(3):
            r.render_surface(scene, params)
        ops = chip_smoke._graph_ops(r._program.graph)
        copies = ops.get("copies and memsets", 0)
        print(f"{opts.tag} config{c}: {sum(ops.values()) - copies} kernels and {copies} copies "
              f"or memsets a frame program ({len(r.compile_log)} program); on {smi}")
        if opts.out:
            with open(os.path.join(opts.out, f"{opts.tag}_config{c}.json"), "w") as f:
                json.dump(ops, f, indent=0, sort_keys=True)


if __name__ == "__main__":
    main()
