#!/usr/bin/env python3
"""What a traced replay of a captured frame needs to crash, each case in a
fresh process.

    python3 tools/replay_crash.py [--variants pre+drop+empty+trace,...]
    python3 tools/replay_crash.py --one pre+drop+empty+trace   # one case, here

The sequence that crashed chip_smoke on an H100 (a segmentation fault in
cudaGraphLaunch): renderer X captures its program, renderer Y captures its
own later, Y is dropped, and X's program is replayed inside a
`Profiler.device_trace` session. X renders the over-minified image frame
(512x512: its first frame a replay, then the reroute to the reference fine
stage), Y 400 discs at 1920x1080, at scale 1 and then 8 (a grown class: two
programs). A case is the sequence with these words on (joined by "+"):

  pre    one traced eager frame before anything is captured (CUPTI up, and
         with torch's default, torn down again, before the captures);
  drop   Y dropped (gc.collect, after a synchronize) before X's replay;
  empty  torch.cuda.empty_cache() after the drop (Y's pools are freed with
         cudaFree);
  trace  X's replay inside a device trace (else a plain replay);
  after  X captured after Y's drop (else before Y's capture);
  many   closer to chip_smoke: twelve traced eager frames before the
         captures (CUPTI up and torn down twelve times), a third renderer
         Z with programs for configs 1 and 3 kept alive and replayed
         untraced after the drop, a second dropped renderer (config 3),
         and X traced three times.

Each case runs in its own process, since a crash takes the process; the
tool prints each case's exit status (a negative one is the signal) and the
card's name and power limit, and exits 0 when every case ended, whatever
its status: the statuses are the finding.
"""

import argparse
import gc
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = ("pre+drop+empty+trace", "pre+empty+trace", "pre+drop+trace", "drop+empty+trace",
            "pre+drop+empty", "pre+drop+empty+trace+after")


def _settle(r, scene, params, renders=3):
    """Renders of one scene until its class's program replays."""
    for _ in range(renders):
        r.render_device(scene, params)


def one(words):
    """The case `words` in this process."""
    import tempfile

    import torch

    import chip_smoke
    import jello_tpu_torch as jt
    from jello_tpu_torch.cuda import Renderer, build
    from jello_tpu_torch.profiler import Profiler
    from jello_tpu_torch.scenes import GATE_SCENES

    build.kernels()
    scene_x, params_x = chip_smoke._over_minified_scene(jt)
    scene_y1, params_y = chip_smoke._discs(jt, 1.0)
    scene_y8, _ = chip_smoke._discs(jt, 8.0)

    def traced(fn):
        with tempfile.TemporaryDirectory() as d:
            with Profiler().device_trace(d):
                fn()

    many = "many" in words
    configs = [GATE_SCENES[k]() for k in (1, 3)] if many else []
    if "pre" in words:
        r_pre = Renderer(device="cuda")
        for i in range(12 if many else 1):
            traced(lambda: r_pre.render_device(*([(scene_y1, params_y)] + configs)[i % 3]))
        del r_pre
    r_z = Renderer(device="cuda")
    for sc in configs:
        _settle(r_z, *sc)
    r_x = Renderer(device="cuda")
    if "after" not in words:
        _settle(r_x, scene_x, params_x)
    r_y = Renderer(device="cuda")
    _settle(r_y, scene_y1, params_y)
    _settle(r_y, scene_y8, params_y, 2)
    r_y2 = Renderer(device="cuda")
    for sc in configs[1:]:
        _settle(r_y2, *sc)
    print(f"{words}: X programs {len(r_x.compile_log)}, Y programs {len(r_y.compile_log)}, "
          f"{len(r_y2.compile_log)}", flush=True)
    torch.cuda.synchronize()
    if "drop" in words:
        del r_y, r_y2
        gc.collect()
    if "empty" in words:
        torch.cuda.empty_cache()
    for sc in configs:
        for _ in range(4):
            r_z.render_device(*sc)
    if "after" in words:
        _settle(r_x, scene_x, params_x)
    t = time.perf_counter()
    if "trace" in words:
        for _ in range(3 if many else 1):
            traced(lambda: r_x.render_device(scene_x, params_x))
    else:
        for _ in range(3):
            r_x.render_device(scene_x, params_x)
    torch.cuda.synchronize()
    print(f"{words}: X's replay ran ({time.perf_counter() - t:.2f} s), "
          f"{r_x._programs and len(r_x._programs)} programs", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--one", help="run one case in this process")
    opts = ap.parse_args()
    if opts.one:
        import faulthandler

        faulthandler.enable(all_threads=True)
        one(set(opts.one.split("+")))
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    from jello_tpu_torch.cuda import build

    build.kernels()  # once, before the cases load it
    status = {}
    for v in opts.variants.split(","):
        t = time.perf_counter()
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", v],
                             capture_output=True, text=True, timeout=600)
        tail = (res.stdout + res.stderr).strip().splitlines()[-12:]
        status[v] = res.returncode
        print(f"--- {v}: exit status {res.returncode} ({time.perf_counter() - t:.1f} s)\n"
              + "\n".join(tail), flush=True)
    print("cases: " + "; ".join(f"{v} {rc}" for v, rc in status.items()) + f"; on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
