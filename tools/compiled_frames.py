#!/usr/bin/env python3
"""The compiled frame on one NVIDIA GPU: each case's program against the
eager frame at the same class.

    python3 tools/compiled_frames.py [--cases 1:area,5:msaa8,4:area:b8,5:area:tap0]
        [--rounds 3] [--frames 8]

A case is config:mode[:b8|:tap0] (b8: JELLO_INTERP_BATCH=1, kernel H; tap0:
JELLO_IMAGE_TAP=0). For each, a fresh Renderer(device="cuda") settles the
scene's class (eager frames), the next render_surface builds the class's
program (capture seconds from `compile_log`), and then: the replayed fine
output and u8 surface against `render_frame` run eagerly at the same class
(bit for bit, SHA-256 printed), and ms/frame and the host's enqueue ms of
`rounds` rounds of `frames` replayed frames alternated with as many rounds
of eager frames (each frame's flags packed, not read; chip_smoke's
`_alternated`, after two replays to warm up). Prints the card's name and
power limit beside the numbers; exits non-zero on a difference.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (blocks JAX and jello_tpu; its frame helpers)

CASES = ("1:area,1:msaa8,3:area,3:msaa8,2:area,2:msaa8,5:area,5:msaa8,4:area,4:msaa8,"
         "4:msaa16,4:area:b8,5:area:tap0")


def run_case(case, scenes, smi):
    import dataclasses

    import torch

    from jello_tpu_torch.cuda import Renderer
    from jello_tpu_torch.cuda.render import assemble, assemble_present, output_layout
    from jello_tpu_torch.renderer.params import AaConfig

    sha = chip_smoke._sha
    cfg, aa, *switch = case.split(":")
    env = {"b8": ("JELLO_INTERP_BATCH", "1"), "tap0": ("JELLO_IMAGE_TAP", "0")}
    for s in switch:
        os.environ[env[s][0]] = env[s][1]
    try:
        scene, params = scenes[int(cfg)]
        params = dataclasses.replace(params, antialiasing_method=AaConfig(aa))
        r = Renderer(device="cuda")
        t = time.perf_counter()
        r.render_surface(scene, params)
        first_s = time.perf_counter() - t
        t = time.perf_counter()
        u8 = r.render_surface(scene, params)
        build_s = time.perf_counter() - t
        log = list(r.compile_log)
        r.render_surface(scene, params)
        fine, _ = r.render_device(scene, params)
        if len(r.compile_log) != 1 or len(log) != 1:
            raise SystemExit(f"FAIL {case}: compile_log {r.compile_log}")
        prepared = r._prepare(scene, params)
        fine_e, _, _ = chip_smoke._eager_frame(r, prepared, params)
        out_ld = output_layout(prepared[1], prepared[2][1])
        u8_e = assemble_present(fine_e, out_ld, True, True).cpu().numpy()
        # The fine output as assembly reads it: rows of records outside
        # every tile's run are never written.
        fine = (assemble(fine, out_ld), fine[1])
        fine_e = (assemble(fine_e, out_ld), fine_e[1])
        same = all(torch.equal(a, b) for a, b in zip(fine, fine_e))
        same_u8 = bool((u8 == u8_e).all())
        print(f"{case}: first render {first_s:.3f} s ({r.last_retries}); the build's render "
              f"{build_s:.3f} s, capture {log[0][1]:.3f} s ({log[0][2]}); replayed fine output "
              f"{sha(*fine)[:16]} vs eager {sha(*fine_e)[:16]}: equal {same}; u8 "
              f"{sha(torch.from_numpy(u8))[:16]} vs {sha(torch.from_numpy(u8_e))[:16]}: equal "
              f"{same_u8}", flush=True)
        if not same or not same_u8:
            raise SystemExit(f"FAIL {case}: the replayed frame differs from the eager frame")

        def replay():
            return r._enqueue(prepared, params, r._caps)

        for _ in range(2):
            replay()
        ms, enq = chip_smoke._alternated(
            replay, lambda: chip_smoke._eager_frame(r, prepared, params))
        print(f"{case}: " + "; ".join(
            f"{k} ms/frame {[round(v, 3) for v in ms[k]]} (median "
            f"{statistics.median(ms[k]):.3f}), enqueue ms median "
            f"{statistics.median(enq[k]):.3f}" for k in ms)
            + f"; peak {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, reserved "
            f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB; on {smi}", flush=True)
        return r
    finally:
        for s in switch:
            del os.environ[env[s][0]]


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", default=CASES)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--frames", type=int, default=8)
    opts = ap.parse_args()
    chip_smoke.ROUNDS, chip_smoke.FRAMES = opts.rounds, opts.frames
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}; torch {torch.__version__}, cuda {torch.version.cuda}")
    from jello_tpu_torch.cuda import build
    from jello_tpu_torch.scenes import GATE_SCENES

    t = time.perf_counter()
    build.kernels()
    print(f"build: {time.perf_counter() - t:.1f} s")
    cases = [c for c in opts.cases.split(",") if c]
    scenes = {k: GATE_SCENES[k]() for k in sorted({int(c.split(":")[0]) for c in cases})}
    kept = [run_case(c, scenes, smi) for c in cases]
    print(f"{len(kept)} renderers alive: peak {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB,"
          f" reserved {torch.cuda.memory_reserved() / 2**20:.1f} MiB; on {smi}")


if __name__ == "__main__":
    main()
