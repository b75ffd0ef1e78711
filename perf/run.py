#!/usr/bin/env python3
"""Benchmark harness of the tripolar-grid ocean engine on one NVIDIA GPU.

    python perf/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell's configuration, traffic mix, initial
state, reference, counts and metric readers are found by the names in
BENCHMARK.json (perf/configs/<config>.json and .py, perf/traffic/<mix>.json,
perf/init/<config>.py, perf/counts/<config>.py, perf/metrics/<metric>.py). A run
builds the model through the configuration's example ``build`` with a seeded
initial state, compiles (from the persistent cache after the first run), runs the
compared first steps through the window's own compiled call, measures for
``--seconds``, and with ``--trace 1`` traces a short window after it. Once the
program's state is freed it runs the plain reference in float64 over the compared
steps and judges ``correct``. The last line of stdout is the result as one JSON
object; the numbers compared, each with its limit, are the last lines of stderr and
the result's last key. Without a GPU, or with fewer than the cell's chips, it exits
non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

PERF = os.path.dirname(os.path.abspath(__file__))
WINDOW_SPAN = "harness.window"
HOST_SPANS = ("dispatch", "sync", "wizard", "progress", "nan_check", "output")
COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                  "/jax/core/compile/jaxpr_to_mlir_module_duration",
                  "/jax/core/compile/backend_compile_duration")


class NoDevice(RuntimeError):
    pass


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """BENCHMARK.json under ``root`` and the files its names lead to."""

    def __init__(self, root):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def path(self, *parts):
        return os.path.join(self.root, *parts)

    def cell(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.spec["configs"]:
            if c["name"] == name:
                with open(self.path(c["file"])) as f:
                    return json.load(f), self.path(os.path.splitext(c["file"])[0] + ".py")
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name):
        with open(self.path("perf", "traffic", name + ".json")) as f:
            return json.load(f)

    def module(self, kind, name):
        return load_module(self.path("perf", kind, name + ".py"),
                           f"perf_{kind}_{name}".replace(".", "_"))

    def metrics(self, cell, kind):
        """The cell's metrics of ``kind`` (end_to_end or per_layer)."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or cell["name"] in m["workloads"]]


class CompileLog:
    """JAX's compile events (trace, lowering, backend compile or cache load) as
    (event, end time, seconds), while registered."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        import jax.monitoring

        jax.monitoring.register_event_duration_secs_listener(self._on)
        return self

    def __exit__(self, *exc):
        import jax.monitoring

        jax.monitoring.unregister_event_duration_listener(self._on)

    def _on(self, event, duration, **_):
        if event in COMPILE_EVENTS:
            self.events.append((event, time.perf_counter(), duration))

    def seconds(self):
        return sum(d for _, _, d in self.events)

    def compiles(self, t0, t1):
        return sum(1 for e, t, _ in self.events
                   if e == COMPILE_EVENTS[-1] and t0 <= t <= t1)


def card_info():
    """nvidia-smi's name, power limit, SM clock and power draw of the cards. Read just
    before and just after the window, never inside it: a query takes the GPU
    driver's locks and would stall the host loop it measures."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip()


def copy_bandwidth():
    """GB/s of a plain read-and-write pass over 512 MiB on the card."""
    import jax
    import jax.numpy as jnp

    x = jnp.ones((2**27,), jnp.float32)
    f = jax.jit(lambda a: a + 1.0)
    y = f(x).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(10):
        y = f(y)
    y.block_until_ready()
    return 10 * 2 * x.nbytes / (time.perf_counter() - t0) / 1e9


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def require_devices(chips):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise NoDevice(f"no GPU: JAX's devices are {devs}")
    if len(devs) < chips:
        raise NoDevice(f"the cell needs {chips} GPU(s), JAX sees {len(devs)}")
    return devs


def set_compile_cache(root):
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", os.path.join(root, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


def run_cell(bench, name, seed, seconds, trace, *, require_gpu=True, overrides=None,
             peaks=None, t_start=None):
    """One run of cell ``name``; returns the result object. ``overrides`` replaces
    keys of the configuration (the tests' small sizes); ``peaks`` replaces the peak
    table (the tests' CPU); ``require_gpu=False`` skips the look for a GPU."""
    t_start = time.perf_counter() if t_start is None else t_start
    for p in (PERF, os.path.dirname(PERF)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import jax
    import jax.numpy as jnp

    import compare
    import loops
    import trace_reduce

    cell = bench.cell(name)
    cfg, ref_path = bench.config(cell["config"])
    cfg = {**cfg, **(overrides or {})}
    traffic = bench.traffic(cell["traffic"])
    init = bench.module("init", cell["config"])
    counts = bench.module("counts", cell["config"])
    reference = load_module(ref_path, "perf_reference_" + cell["config"])
    set_compile_cache(os.path.dirname(PERF))
    devs = require_devices(cell["chips"]) if require_gpu else jax.devices()
    dev = devs[0]
    if peaks is None:
        with open(os.path.join(PERF, "peaks.json")) as f:
            peaks = json.load(f)
    if dev.device_kind not in peaks:
        raise KeyError(f"perf/peaks.json has no entry for {dev.device_kind!r}")
    log(f"device: {dev.platform} {dev.device_kind} x{len(devs)}; jax {jax.__version__}")

    spans = loops.Spans()
    with CompileLog() as clog, tempfile.TemporaryDirectory(prefix="perf-") as work:
        example = importlib.import_module(cfg["example"])
        t0 = time.perf_counter()
        model, _ = example.build(**cfg["build"])
        state = init.program_state(model, seed)
        jax.block_until_ready(state)
        build_s = time.perf_counter() - t0
        loop = loops.make(traffic, cfg, model, state, spans, init, work)
        del state
        snapshot = reference.program_fields(cfg, loop.setup())
        it_start = int(loop.state.iteration)
        setup = {"setup_s": time.perf_counter() - t_start, "build_s": build_s,
                 "compile_s": clog.seconds()}
        log(f"set-up: {setup}")

        card_before = card_info()
        window = loop.run(seconds)
        card_after = card_info()
        t_end = window["t0"] + window["seconds"]
        window_spans = spans.since(window["t0"])
        log(f"window: {window['steps']} steps in {window['seconds']:.6f} s; "
            f"compilations inside it: {clog.compiles(window['t0'], t_end)}")
        log(f"card before the window: {card_before}")
        log(f"card after the window: {card_after}")
        peak_bytes = (dev.memory_stats() or {}).get("peak_bytes_in_use", 0)

        red, traced_steps = None, 0
        if trace:
            tdir = os.path.join(work, "trace")
            opts = jax.profiler.ProfileOptions()
            opts.python_tracer_level = 0
            spans.annotate = True
            with jax.profiler.trace(tdir, profiler_options=opts):
                with jax.profiler.TraceAnnotation(WINDOW_SPAN):
                    traced_steps = loop.run(traffic["trace_seconds"])["steps"]
            spans.annotate = False
            red = trace_reduce.reduce_trace(trace_reduce.latest_xplane(tdir), WINDOW_SPAN,
                                            HOST_SPANS)
            log(f"trace: {traced_steps} steps, busy {red['busy_s']:.6f} s of "
                f"{red['window_s']:.6f} s")

        final = loop.state
        n_nonfinite = compare.nonfinite(final)
        iteration_gap = abs(int(final.iteration)
                            - (it_start + window["steps"] + traced_steps))
        compared_steps = loop.compared_steps
        loop.close()
        del final, loop, model

    if require_gpu:
        log(f"copy bandwidth: {copy_bandwidth():.1f} GB/s (read + write, 512 MiB)")
    t_ref = time.perf_counter()
    jax.config.update("jax_enable_x64", True)
    try:
        ref = reference.Reference(cfg, init.fields(seed), jnp.float64)
        gaps = compare.field_gaps(snapshot, ref.fields(ref.run(compared_steps, cfg["dt"])))
        del ref
    finally:
        jax.config.update("jax_enable_x64", False)
    log(f"reference: {compared_steps} steps in float64, {time.perf_counter() - t_ref:.1f} s")
    rows = compare.checks(gaps, reference.LIMITS, iteration_gap, n_nonfinite)

    b = cfg["build"]
    ctx = types.SimpleNamespace(
        cfg=cfg, counts=counts, peak=peaks[dev.device_kind], dtype=cfg["dtype"],
        points=b["nx"] * b["ny"] * b.get("nz", 1), setup=setup, window=window,
        window_spans=window_spans, trace=red, traced_steps=traced_steps,
        peak_bytes=peak_bytes)
    metrics = {}
    for m in bench.metrics(cell, "per_layer" if trace else "end_to_end"):
        value = bench.module("metrics", m["name"]).read(ctx)
        if value is None:
            log(f"metric {m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device = {"platform": dev.platform, "kind": dev.device_kind, "count": len(devs),
              "memory_peak_bytes": peak_bytes}
    result = {"correct": compare.passed(rows), "attempted": window["steps"],
              "failed": window["steps"] if n_nonfinite else 0, "metrics": metrics,
              "device": device}
    if trace:
        device.update(busy_s=red["busy_s"], window_s=red["window_s"])
        result["breakdown"] = trace_reduce.breakdown(red)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = Bench(os.path.dirname(PERF))
    try:
        result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=T_START)
    except NoDevice as e:
        log(f"perf/run.py: {e}")
        return 3
    for n, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILS"
        log(f"check {n}: {c['value']!r} <= {c['limit']!r} {ok}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
