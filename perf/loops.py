"""The one traffic generator: drives the program under a traffic mix read from
perf/traffic/<mix>.json. Two loops exist, both closed, with one caller that
advances the simulation as fast as the card allows:

- ``scan``: the jitted ``multi_step`` of ``steps_per_call`` steps, state donated,
  called back to back; the host waits for the card every ``sync_every_s`` of its
  work (measured in set-up), so the window ends when the work does.
- ``simulation``: the package's ``Simulation`` loop as the examples drive it, with a
  time-step wizard and a progress line every few iterations, a NaN check, and a
  synchronous output writer on simulated time; each callback runs inside a span.

Each loop runs its first steps in set-up through the same compiled call the window
drives, and keeps the fields the reference is compared with."""

from __future__ import annotations

import contextlib
import importlib
import os
import time
from functools import partial


def resolve(spec):
    """``"package.module:attr"`` -> the attribute."""
    mod, attr = spec.split(":")
    return getattr(importlib.import_module(mod), attr)


class Spans:
    """Host spans of the harness: (name, start, end) on ``time.perf_counter``; with
    ``annotate`` on, each is also a ``TraceAnnotation`` in the profiler's trace."""

    def __init__(self):
        self.items = []
        self.annotate = False

    @contextlib.contextmanager
    def __call__(self, name):
        import jax

        t0 = time.perf_counter()
        cm = jax.profiler.TraceAnnotation(name) if self.annotate else contextlib.nullcontext()
        with cm:
            yield
        self.items.append((name, t0, time.perf_counter()))

    def callback(self, name, fn):
        """A simulation callback in its span, after a ``sync`` span that waits for
        the card: every callback here reads the state, so it would wait there
        anyway, and its own span then holds only its own work."""
        import jax

        def wrapped(sim):
            with self("sync"):
                jax.block_until_ready(sim.state)
            with self(name):
                fn(sim)
        return wrapped

    def since(self, t0):
        return [s for s in self.items if s[1] >= t0]


class ScanLoop:
    def __init__(self, traffic, cfg, model, state, spans, **_):
        import jax

        self.block = int(traffic["steps_per_call"])
        self.compare_calls = int(traffic["compare_calls"])
        self.sync_every_s = float(traffic["sync_every_s"])
        self.dt = float(cfg["dt"])
        self.model, self.state, self.spans = model, state, spans
        fn = jax.jit(partial(resolve(cfg["multi_step"]), n_steps=self.block),
                     donate_argnums=(1,))
        self.call = fn.lower(model, state, self.dt).compile()
        self.compared_steps = self.block * self.compare_calls
        self.sync_every = 1

    def setup(self):
        """The compared steps, through the window's own call; returns the state
        they produce (still on the card) and sets how often the window syncs."""
        import jax

        s, took = self.state, 0.0
        for _ in range(self.compare_calls):
            t0 = time.perf_counter()
            s = jax.block_until_ready(self.call(self.model, s, self.dt))
            took = time.perf_counter() - t0
        self.sync_every = max(1, int(self.sync_every_s / max(took, 1e-6)))
        self.state = s
        return s

    def run(self, seconds):
        """Calls back to back until ``seconds`` have passed at a sync point."""
        import jax

        s, calls = self.state, 0
        t0 = time.perf_counter()
        while True:
            with self.spans("dispatch"):
                s = self.call(self.model, s, self.dt)
            calls += 1
            if calls % self.sync_every == 0:
                with self.spans("sync"):
                    jax.block_until_ready(s)
                if time.perf_counter() - t0 >= seconds:
                    break
        t1 = time.perf_counter()
        self.state = s
        return {"steps": calls * self.block, "seconds": t1 - t0, "t0": t0}

    def close(self):
        self.state = self.model = self.call = None


class SimulationLoop:
    def __init__(self, traffic, cfg, model, state, spans, init, workdir, **_):
        from orthogonalsphericalshellgrids_tpu.utils import (
            IterationInterval, NaNChecker, OutputWriter, Simulation, TimeInterval,
            TimeStepWizard, progress_callback)

        self.compared_steps = int(traffic["compare_iterations"])
        dt = float(cfg["dt"])
        sim = Simulation(model, state, dt=dt, steps_per_block=int(traffic["steps_per_block"]),
                         nan_checker=False)
        sim.add_callback(spans.callback("nan_check", NaNChecker()),
                         IterationInterval(traffic["nan_every"]))
        wz = traffic["wizard"]
        # the wizard is capped at the configured dt, so every run does the same work
        wizard = TimeStepWizard(cfl=wz["cfl"], max_change=wz["max_change"], max_dt=dt)
        sim.add_callback(spans.callback("wizard", lambda s: setattr(
            s, "dt", wizard.update(s.model, s.state, s.dt))), IterationInterval(wz["every"]))
        self._log = open(os.path.join(workdir, "progress.log"), "w")
        progress = progress_callback(log=lambda line: self._log.write(line + "\n"))
        self.progress_times = []

        def progress_timed(s):
            progress(s)
            self.progress_times.append(time.perf_counter())

        sim.add_callback(spans.callback("progress", progress_timed),
                         IterationInterval(traffic["progress_every"]))
        self.writer = OutputWriter(os.path.join(workdir, "output.npz"), init.outputs())
        sim.add_callback(spans.callback("output", self.writer),
                         TimeInterval(traffic["output_every_s"]))
        self.nan_check = NaNChecker()
        self.deadline = None
        sim.add_callback(self._stop, IterationInterval(traffic["progress_every"]))
        self.sim = sim

    def _stop(self, sim):
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            sim.stop_iteration = 0

    @property
    def state(self):
        return self.sim.state

    def setup(self):
        """The compared iterations through the loop itself (which compiles the step
        and warms the wizard, progress and output), then one NaN check to warm it."""
        self.sim.stop_iteration = self.compared_steps
        self.sim.run()
        self.nan_check(self.sim)
        return self.sim.state

    def run(self, seconds):
        it0 = self.sim.iteration
        self.sim.stop_iteration = 2**62
        self.progress_times = []
        t0 = time.perf_counter()
        self.deadline = t0 + seconds
        self.sim.run()
        t1 = time.perf_counter()
        self.deadline = None
        return {"steps": self.sim.iteration - it0, "seconds": t1 - t0, "t0": t0,
                "progress_times": list(self.progress_times)}

    def close(self):
        self._log.close()
        self.sim = self.writer = None


LOOPS = {"scan": ScanLoop, "simulation": SimulationLoop}


def make(traffic, cfg, model, state, spans, init, workdir):
    return LOOPS[traffic["loop"]](traffic, cfg, model, state, spans, init=init,
                                  workdir=workdir)
