"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. Set-up makes the cell's mesh from the seed and runs the traffic
mix's warm-up requests; then one waiting caller sends requests for
``--seconds`` (the window closes when the request under way at that
moment returns). With ``--trace 1`` a slice of the window's requests runs
under ``torch.profiler``. After the window a sample of the window's
answers, drawn from the seed, is judged against the plain reference
(``benchmark/reference/``). The last line of standard output is the
result, one JSON object; the numbers judged, each beside its limit, are
the last lines of standard error and the result's last key.
"""
import time

T_START = time.perf_counter()  # set-up counts from here, before the heavy imports

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "fea_tpu")  # top-level module names, compared whole


def _cache_env(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    checkout's first run builds; the program's own nvcc builds go to
    ``fea_tpu_torch/_build/`` in the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / ".bench_cache" / sub)


_cache_env(ROOT)
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import load, spec, trace  # noqa: E402
from benchmark.harness.client import Client  # noqa: E402
from benchmark.reference import check  # noqa: E402


def _args(argv):
    p = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _card(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(dev), count=1)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def _peak(dev: torch.device) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else x


def _forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None, *, root: Path = ROOT, device=None, api=None, warmup=None) -> int:
    """One run; returns the exit code. ``device``, ``api`` and ``warmup``
    are for the benchmark's tests and its control: the benchmark proper
    takes a CUDA card and the program ``fea_tpu_torch``."""
    args = _args(argv)
    bench = spec.Bench(root)
    cell = bench.cell(args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"benchmark: {args.workload} needs {cell['chips']} CUDA card(s); "
                  f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
                  f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = "cuda"
    stages = [("imports", time.perf_counter())]
    if api is None:
        import fea_tpu_torch as api
    dev = torch.device(device)
    stages.append(("program import", time.perf_counter()))
    config = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    gen = load.Generator(config, mix, bench.mesh_module(config["mesh"]), args.seed)
    client = Client(api, gen, dev)
    stages.append(("mesh and scene", time.perf_counter()))

    # set-up: the mix's warm-up requests
    n_warm = mix["warmup_requests"] if warmup is None else warmup
    slots = load.HostSlots(mix["check_requests"], pin=dev.type == "cuda")
    for r in range(n_warm):
        _, u, reac = client.request(r)
        slots.reserve(u, reac)
        stages.append((f"warm-up request {r}", time.perf_counter()))
    u = reac = None
    setup_peak = _peak(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - T_START

    # the window
    records, sample = [], load.Reservoir(mix["check_requests"], args.seed)
    kept: dict = {}
    prof = None

    def one(r: int, profiled: bool = False) -> None:
        rec, u, reac = client.request(r)
        rec.profiled = profiled
        records.append(rec)
        slot = sample.wants()
        if slot is not None:  # to the host, but not inside the traced slice
            kept[slot] = (rec, u, reac) if profiled else (rec, *slots.store(slot, u, reac))

    t0 = time.perf_counter()
    r = n_warm
    one(r)
    r += 1
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(trace.SLICE):
                for _ in range(mix["trace_requests"]):
                    one(r, profiled=True)
                    r += 1
        kept = {k: (rec, _host(u), _host(reac)) for k, (rec, u, reac) in kept.items()}
    while time.perf_counter() - t0 < args.seconds:
        one(r)
        r += 1
    window_s = records[-1].done_at - t0
    window_peak = _peak(dev)

    # after the window: the program's state goes, then the trace and the reference
    client = None
    if hasattr(api, "clear_build_cache"):
        api.clear_build_cache()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    marks = [T_START] + [t for _, t in stages]
    lines = [f"# card: {_power_limit() if dev.type == 'cuda' else 'cpu'}",
             "# set-up s: " + ", ".join(f"{n} {marks[i + 1] - marks[i]:.3f}" for i, (n, _) in enumerate(stages)),
             f"# window: requests {n_warm}..{r - 1}, {window_s} s; routes "
             f"{sorted({str(x.route) for x in records})}; load cases judged: {sum(k[0].cases for k in kept.values())}"]
    traced = None
    if prof is not None:
        with tempfile.TemporaryDirectory() as tmp:  # under TMPDIR; the launches' grids are in the file alone
            prof.export_chrome_trace(os.path.join(tmp, "slice.json"))
            with open(os.path.join(tmp, "slice.json")) as f:
                traced = trace.reduce(json.load(f))
        lines.append(f"# traced slice: window requests 1..{mix['trace_requests']}, {traced.window_s} s")
        prof = None

    readings, gap = [], 0.0
    for slot in sorted(kept):
        rec, u, reac = kept[slot]
        mesh = gen.mesh(rec.r)
        readings.append(check.judge(mesh["nodes"], mesh["elements"], mesh["fixed"], gen.loads(rec.r, mesh), u, reac,
                                    rec.converged, config["E"], config["nu"], dev))
        gap = max([gap] + [abs(a - b) for a, b in zip(readings[-1]["residual"], rec.relative_residual)
                           if a is not None])
    lines.append(f"# the reference's residual against the program's own, widest gap: {gap!r}")
    lat = np.percentile([x.latency_s for x in records], [0, 25, 50, 75, 100])
    lines.append("# request s, min / quartiles / max: " + " / ".join(f"{v:.4f}" for v in lat)
                 + f"; the window's first {records[0].latency_s:.4f}")
    quarter = [0] * 4
    for x in records:
        quarter[min(3, int(4 * (x.done_at - t0) / window_s))] += x.dof * sum(x.converged)
    lines.append("# solved DOF/s by quarter of the window: " + " / ".join(f"{4 * q / window_s:.0f}" for q in quarter))
    lines += [f"# not certified: request {x.r} case {i}: {x.iterations[i]} iterations, its residual "
              f"{x.relative_residual[i]!r}" for x in records for i, ok in enumerate(x.converged) if not ok]
    limits = config["limits"]
    numbers = check.worst(readings) if readings else {n: float("inf") for n in check.NAMES}
    correct = bool(readings) and check.passes(numbers, limits)
    checks = {n: {"value": numbers[n], "limit": limits[n]} for n in check.NAMES}

    found = _forbidden_modules()
    if found:
        print(f"benchmark: the process holds {found} after the window", file=sys.stderr)
        return 3

    attempted = sum(x.cases for x in records)
    failed = sum(1 for x in records for ok in x.converged if not ok)
    units = {m["name"]: m["unit"] for m in bench.data["end_to_end"] + bench.data["per_layer"]}
    if args.trace:
        run = SimpleNamespace(config=config, requests=records, trace=traced)
        values = {m["name"]: bench.reader(m)(run) for m in bench.metrics("per_layer", args.workload)}
    else:
        solved = sum(x.dof for x in records for ok in x.converged if ok)
        values = {
            "solved_dof_per_s": solved / window_s,
            "request_s_p95": float(np.percentile([x.latency_s for x in records], 95)),
            "peak_device_gb": window_peak / 1e9,
            "setup_s": setup_s,
        }
        values = {m["name"]: values[m["name"]] for m in bench.metrics("end_to_end", args.workload)}
    device_info = _card(dev) | {"memory_peak_bytes": max(setup_peak, window_peak)}
    if traced is not None:
        device_info |= {"busy_s": traced.busy_s, "window_s": traced.window_s}
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items() if v is not None},
        "device": device_info,
    }
    if traced is not None:
        result["breakdown"] = traced.breakdown
    result["checks"] = checks
    for line in lines:
        print(line)
    sys.stdout.flush()
    for n, c in checks.items():
        print(f"check {n}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
