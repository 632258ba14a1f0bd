"""What the benchmark's tests share: the harness and the program on the
path, and a copy of the benchmark with tiny cells added by data alone."""

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

# Few threads: the test runner may run several workers.
torch.set_num_threads(2)

# Small versions of the cells' configurations (sizes only).
TINY = {
    "tiger_text": {"n_paths": 80, "width": 160, "height": 96},
    "clip_layers": {"n_stacks": 4, "clip_radius_px": [10, 30], "width": 160, "height": 96},
}


def tiny_copy(dst: Path):
    """A copy of the benchmark under dst/benchmark with BENCHMARK.json
    beside it, holding tiny configurations (`tiny_<config>`), a six-frame
    turn of the pan traffic (`tiny_pan`) and, for each configuration and
    traffic, a cell `tiny_<config>.<traffic>`. Returns (bench_dir, bench)."""
    bench_dir = dst / "benchmark"
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, sizes in TINY.items():
        cfg = json.loads((bench_dir / "configs" / f"{name}.json").read_text())
        cfg.update(sizes)
        (bench_dir / "configs" / f"tiny_{name}.json").write_text(json.dumps(cfg))
        shutil.copy(bench_dir / "configs" / f"{name}.py", bench_dir / "configs" / f"tiny_{name}.py")
        bench["configs"].append({"name": f"tiny_{name}", "source": "test",
                                 "file": f"benchmark/configs/tiny_{name}.json", "reduced": [],
                                 "why": "test"})
    for name in ("static", "pan"):
        mix = json.loads((bench_dir / "traffic" / f"{name}.json").read_text())
        mix["trace_frames"] = 2
        if mix.get("motion"):
            mix["motion"]["period_frames"] = 6
            mix["warmup_frames"] = 6
        (bench_dir / "traffic" / f"tiny_{name}.json").write_text(json.dumps(mix))
        for cfg in TINY:
            bench["workloads"].append({"name": f"tiny_{cfg}.{name}", "config": f"tiny_{cfg}",
                                       "traffic": f"tiny_{name}", "chips": 1, "why": "test"})
    # A metric listed for the real cells of a traffic mix is listed for the
    # tiny cells of that mix too.
    traffic_of = {w["name"]: w["traffic"].removeprefix("tiny_") for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            mixes = {traffic_of[c] for c in m["workloads"]}
            m["workloads"] += [f"tiny_{cfg}.{mix}" for mix in sorted(mixes) for cfg in TINY]
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench_dir, bench
