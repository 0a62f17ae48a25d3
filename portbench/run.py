"""The benchmark of raytracer_tpu_torch, the PyTorch and CUDA port of the
progressive path tracer: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout, on a machine with a CUDA card (the run
exits non-zero without one, and never falls back to the CPU). It makes
the scene and its materials from the seed, sets the renderer up (the
kernels come from the build cache, raytracer_tpu_torch/_build/, after the
first run in a checkout), renders the cell's warm frames, then progressive
frames for `--seconds` (each frame step() and a device sync), and checks
the image against the plain reference at pixels drawn from the seed.
The last line of standard output is the result as one JSON object: with
--trace 0 the cell's end-to-end metrics, with --trace 1 its per-layer
metrics (a few frames profiled with torch.profiler) and a breakdown; the
numbers compared come last, and as the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_tpu")


def card_line():
    """The card's name, power limit and SM clock (nvidia-smi)."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    if proc.returncode != 0:
        return f"nvidia-smi failed: {proc.stderr.strip()}"
    return proc.stdout.strip().splitlines()[0]


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: raytracer_tpu_torch is the port)."""
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for path in (HERE, ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)
    # The build cache stays at its fixed place inside the checkout.
    os.environ.pop("RAYTRACER_TPU_CACHE_DIR", None)
    from harness import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark measures the card "
              "only", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    try:
        import raytracer_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        print(f"portbench: the port is not in this checkout: {e}",
              file=sys.stderr)
        return 3
    from harness import cell as cells

    readers = spec.readers(cell.per_layer) if args.trace else {}
    out = cells.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; the benchmark "
              "measures the port alone", file=sys.stderr)
        return 4
    tag = f"[{card_line()}; torch {torch.__version__}]"

    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = readers[m["name"]](out["run"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = cells.e2e_metrics(out)
        metrics = {m["name"]: e2e[m["name"]] for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": out["memory_peak"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace:
        tr = out["run"].trace
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.wall_s
        result["breakdown"] = {"device_ops": tr.device_ops,
                               "idle_gaps": tr.idle_gaps}
    result["check"] = out["check"]
    print(f"portbench {tag} {cell.name} seed {args.seed} seconds "
          f"{args.seconds} trace {args.trace}", flush=True)
    print(f"portbench {tag} correct {out['correct']}", file=sys.stderr)
    for name, row in out["check"].items():
        print(f"portbench {tag} check {name} {row['value']!r} limit "
              f"{row['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
