"""Run one cell of the benchmark once, in a new process, and print its one
JSON result line (BENCHMARK.json holds the cells and the contract).

    python3 -m portbench.run --workload CELL --seed N --seconds S --trace 0|1

--trace 0: set-up, then a window of S seconds, then the check; the line's
metrics are the cell's end-to-end metrics. --trace 1: set-up, then one
pass of the mix under torch.profiler, then the check; the line's metrics
are the cell's per-layer metrics, and `device` adds busy_s and window_s.
A run without a CUDA card, with fewer cards than the cell asks for, or
that has loaded JAX or the JAX package, prints no result and exits 1.
"""

from __future__ import annotations

import time

T_START = time.monotonic()  # set-up is timed from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "rosettafold_tpu")
CACHE_DIR = os.path.join(ROOT, ".portbench-cache")


def fail(msg: str, code: int = 1):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def forbidden_modules():
    """Top-level names in sys.modules that the run must not hold, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def find_cell(man: dict, name: str):
    """(cell, configuration file, mix file) of the cell called `name`."""
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    cfg = load_json(os.path.join(ROOT, conf["file"]))
    mix = load_json(os.path.join(HERE, "mixes", f"{cell['traffic']}.json"))
    return cell, cfg, mix


def metrics_of(man: dict, cell: str, kind: str):
    """The manifest's metrics of `kind` that this cell reports."""
    from .metrics import of_cell

    return of_cell(man, cell, kind)


def device_info(n: int) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit"] = out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired, IndexError):
        info["power_limit"] = None
    return info


def set_caches():
    """Every kernel cache at a fixed directory of the checkout."""
    os.makedirs(os.path.join(CACHE_DIR, "triton"), exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")


def execute(args, man: dict, cell: dict, cfg: dict, mix: dict, device="cuda") -> dict:
    """Run the cell once on `device` and return its result line (a dict),
    with `checks`, the numbers compared and their limits, as its last key."""
    from . import check

    loop = importlib.import_module(f".loops.{mix['loop']}", __package__)
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        attempted, failed, values, extra, breakdown, readings = loop.run(
            args, cell, cfg, mix, man, tmp, device, T_START)
    worst = check.worst_of(readings.values())
    correct, rows = check.judge(worst, check.limits(cfg, mix))
    units = {m["name"]: m["unit"] for m in man["end_to_end"] + man["per_layer"]}
    kind = "per_layer" if args.trace else "end_to_end"
    wanted = [m["name"] for m in metrics_of(man, cell["name"], kind)]
    missing = [k for k in wanted if k not in values and kind == "end_to_end"]
    if missing:
        raise RuntimeError(f"end-to-end metrics not measured: {missing}")
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": {k: {"value": values[k], "unit": units[k]} for k in wanted if k in values},
              "device": {"memory_peak_bytes": extra.pop("memory_peak_bytes"), **extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checked"] = {str(L): r for L, r in sorted(readings.items())}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    man = manifest()
    cell, cfg, mix = find_cell(man, args.workload)
    set_caches()
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA card: this benchmark runs only on one")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"{cell['name']} needs {cell['chips']} cards, found {torch.cuda.device_count()}")
    dev = device_info(cell["chips"])
    result = execute(args, man, cell, cfg, mix)
    bad = forbidden_modules()
    if bad:
        fail(f"the run loaded {bad}: the benchmark measures the PyTorch port alone")
    result["device"] = {"platform": dev["platform"], "kind": dev["kind"], "count": dev["count"],
                        **result["device"], "power_limit": dev["power_limit"]}
    # `checks` last, as the contract asks
    result = {k: v for k, v in result.items() if k != "checks"} | {"checks": result["checks"]}
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
