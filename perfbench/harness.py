"""The harness: resolves a cell's files by name, builds and warms up, runs
the window, reads the metrics and decides ``correct``.

A cell ``<config>.<mix>`` of ``BENCHMARK.json`` resolves to
``configs/<config>.json`` (sizes and settings) with ``configs/<config>.py``
(its likelihood, plain torch), ``traffic/<mix>.json`` (the mix's
parameters and the ``generator`` that reads them, ``generators/<generator>.py``),
``limits/<cell>.json`` (the limit of every number its check compares) and,
for each per-layer metric that lists the cell, ``metrics/<metric>.py``.
Nothing here names a cell, configuration, mix or metric.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pocomc_tpu")


def load_module(path: Path, name: str):
    """The module in the file ``path`` (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(spec: dict, cell: str, here: Path = HERE) -> dict:
    """Every file of ``cell``, found by the names in ``spec``."""
    work = {w["name"]: w for w in spec["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json ({sorted(work)})")
    w = work[cell]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    cfg_file = here.parent / conf["file"]
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return dict(workload=w, config=conf, config_file=cfg_file,
                problem_file=cfg_file.with_suffix(".py"),
                traffic_file=here / "traffic" / f"{w['traffic']}.json",
                limits_file=here / "limits" / f"{cell}.json",
                end_to_end=e2e, per_layer=layer,
                metric_files={m["name"]: here / "metrics" / f"{m['name']}.py" for m in layer})


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Context:
    """What a generator and the readers see of the run."""

    def __init__(self, files, seed, cuda, overrides=None):
        from .hooks import Hooks
        overrides = overrides or {}
        self.files = files
        self.seed = int(seed)
        self.cuda = cuda
        with open(files["config_file"]) as f:
            self.cfg = _merge(json.load(f), overrides.get("config"))
        with open(files["traffic_file"]) as f:
            self.mix = _merge(json.load(f), overrides.get("traffic"))
        with open(files["limits_file"]) as f:
            self.limits = json.load(f)
        problem = load_module(files["problem_file"], f"perfbench_problem_{self.cfg['name']}")
        self.likelihood = problem.Likelihood(self.cfg)
        self.generator = importlib.import_module(f"perfbench.generators.{self.mix['generator']}")
        self.hooks = Hooks()


def card_line():
    """The card's name, power limit and clocks (nvidia-smi), or why not."""
    q = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", " | ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e!r}"


def build(names):
    """Build the program's kernel libraries ``names`` at the same time
    into build/pocomc_tpu_torch/ (a library already there is reused).
    Returns (seconds, the names that were compiled)."""
    from pocomc_tpu_torch.ops import _build
    done, errors = [], []

    def one(name):
        try:
            if _build.build(name)[1]:
                done.append(name)
        except Exception as e:  # reported below, after every thread ends
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return time.perf_counter() - t0, sorted(done)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: pocomc_tpu_torch is not pocomc_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _within(row):
    """A number at or under its limit; one with no limit, or one that is
    not finite, is not."""
    return row["limit"] is not None and math.isfinite(row["value"]) and row["value"] <= row["limit"]


def judge(readings: dict, limits: dict):
    """(correct, rows): every number within its limit (``_within``)."""
    rows = {name: {"value": value, "limit": limits.get(name)} for name, value in readings.items()}
    return all(_within(r) for r in rows.values()), rows


def run_cell(cell, seed, seconds, trace, cuda=True, overrides=None, spec=None,
             origin=None, here=HERE, out=sys.stdout, calibrate=False):
    """One run of ``cell``; returns the result dict (the line run.py
    prints). ``cuda=False`` runs the program's plain versions on the CPU
    (the tests' route, at sizes ``overrides`` sets). ``calibrate`` also
    reads the check with the control in the program's place, and with each
    fault the generator lists (``Run.FAULTS``), each judged by the cell's
    limits (``calibration`` in the result)."""
    import torch
    origin = time.perf_counter() if origin is None else origin
    parts = {"start_s": time.perf_counter() - origin}
    spec = load_spec(here.parent) if spec is None else spec
    files = resolve(spec, cell, here)
    ctx = Context(files, seed, cuda, overrides)
    if cuda:
        print(f"# card: {card_line()}", file=out, flush=True)
        t0 = time.perf_counter()
        torch.zeros((), device="cuda")
        parts["cuda_init_s"] = time.perf_counter() - t0
        compile_s, built = build(ctx.generator.libraries(ctx.cfg, ctx.mix))
        parts["build_s"] = compile_s
        print(f"# build: compile_s={compile_s!r} built={built}", file=out, flush=True)
    from .trace import Tracer, WindowTrace
    tracer = Tracer(ctx.hooks, cuda) if trace else None
    # an end-to-end metric read from the device trace: the card's
    # operations over the whole window (a --trace 0 run reports them)
    whole = None
    if not trace and any(m["source"] == "device_trace" for m in files["end_to_end"]):
        whole = WindowTrace(cuda)
    ctx.hooks.install()
    try:
        run = ctx.generator.Run(ctx)
        if cuda:
            torch.cuda.synchronize()
        if whole is not None:
            whole.start()
        setup_s = time.perf_counter() - origin
        parts.update(run.setup_parts)
        print(f"# setup: setup_s={setup_s!r} {json.dumps(parts)}", file=out, flush=True)
        window_s = run.window(float(seconds), tracer)
        busy_s = None
        if whole is not None:
            whole.stop()
            busy_s = whole.busy_s()
            del whole
        e2e = run.end_to_end(window_s, busy_s)
        e2e["setup_s"] = setup_s
        device = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                  "count": int(files["workload"]["chips"]),
                  "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
        counts = run.layer_counts()
        run.release()
        gc.collect()
        correct, checks = judge(run.checks(), ctx.limits)
        calibration = None
        if calibrate:
            calibration = {mode: dict(zip(("correct", "checks"), judge(run.checks(mode),
                                                                       ctx.limits)))
                           for mode in ("control",) + tuple(run.FAULTS)}
        metrics = {}
        breakdown = None
        if trace:
            analysis = tracer.analysis()
            device["busy_s"], device["window_s"] = analysis["busy_s"], analysis["window_s"]
            breakdown = analysis["breakdown"]
            from .metrics_base import LayerView
            view = LayerView(ctx, counts, analysis, window_s)
            for m in files["per_layer"]:
                reader = load_module(files["metric_files"][m["name"]],
                                     "perfbench_metric_" + m["name"].replace(".", "_"))
                value = reader.read(view)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            for m in files["end_to_end"]:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    finally:
        ctx.hooks.uninstall()
    failed = sum(1 for r in checks.values() if not _within(r))
    # attempted: the numbers compared; failed: those past their limits
    result = {"correct": bool(correct), "attempted": len(checks), "failed": failed,
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["layer_counts"] = counts
    result["window_s"] = window_s
    if busy_s is not None:
        result["window_busy_s"] = busy_s
    result["setup_parts"] = parts
    if calibration is not None:
        result["calibration"] = calibration
    result["checks"] = checks
    return result


def main(argv, origin):
    ap = argparse.ArgumentParser(description="One run of a benchmark cell of pocomc_tpu_torch.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec()
    chips = int(resolve(spec, args.workload)["workload"]["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      cuda=True, spec=spec, origin=origin)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}; the benchmark runs pocomc_tpu_torch "
              f"without JAX or the JAX package", file=sys.stderr)
        return 3
    for name, row in result["checks"].items():
        print(f"check {name} = {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
