#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from (not run by the benchmark).

    python perf/calibrate.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3

For each seed it runs the cell's compared first steps through the timed path (the
traffic loop's own compiled call, at the cell's size), then, with the program
freed, the plain reference in float64 over the same steps; each field's gap is the
program's lower reading. For each control seed it runs the same reference in
bfloat16, the precision below the configuration's float32, in the program's place;
its gaps are the upper readings. Prints one JSON object with every reading, the
largest program gap and the smallest control gap per field.
"""

import argparse
import json
import os
import sys
import tempfile

PERF = os.path.dirname(os.path.abspath(__file__))


def readings(bench, name, seeds, control_seeds, overrides=None):
    for p in (PERF, os.path.dirname(PERF)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import importlib

    import jax
    import jax.numpy as jnp

    import compare
    import loops
    import run

    cell = bench.cell(name)
    cfg, ref_path = bench.config(cell["config"])
    cfg = {**cfg, **(overrides or {})}
    traffic = bench.traffic(cell["traffic"])
    init = bench.module("init", cell["config"])
    reference = run.load_module(ref_path, "perf_reference_" + cell["config"])
    run.set_compile_cache(os.path.dirname(PERF))

    snapshots, steps = {}, None
    example = importlib.import_module(cfg["example"])
    model, _ = example.build(**cfg["build"])
    with tempfile.TemporaryDirectory(prefix="perf-") as work:
        for seed in seeds:
            state = init.program_state(model, seed)
            loop = loops.make(traffic, cfg, model, state, loops.Spans(), init, work)
            del state
            snapshots[seed] = reference.program_fields(cfg, loop.setup())
            steps = loop.compared_steps
            loop.close()
            del loop
    del model

    out = {"cell": name, "steps": steps, "program": {}, "control": {}}
    jax.config.update("jax_enable_x64", True)
    try:
        refs = {}
        for seed in sorted(set(seeds) | set(control_seeds)):
            ref = reference.Reference(cfg, init.fields(seed), jnp.float64)
            refs[seed] = ref.fields(ref.run(steps, cfg["dt"]))
            if seed in snapshots:
                out["program"][seed] = compare.field_gaps(snapshots[seed], refs[seed])
            if seed in control_seeds:
                ctl = reference.Reference(cfg, init.fields(seed), jnp.bfloat16)
                got = {k: a for k, (a, _) in ctl.fields(ctl.run(steps, cfg["dt"])).items()}
                out["control"][seed] = compare.field_gaps(got, refs[seed])
            del refs[seed]
    finally:
        jax.config.update("jax_enable_x64", False)
    fields = list(next(iter(out["program"].values())))
    out["lower"] = {f: max(g[f] for g in out["program"].values()) for f in fields}
    if out["control"]:
        out["upper"] = {f: min(g[f] for g in out["control"].values()) for f in fields}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, PERF)
    import run

    run.require_devices(1)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    print(json.dumps(readings(run.Bench(os.path.dirname(PERF)), args.workload, seeds,
                              control)), flush=True)


if __name__ == "__main__":
    main()
