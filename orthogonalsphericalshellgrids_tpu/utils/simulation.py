"""Simulation driver: run loop, callbacks, schedules, adaptive time stepping.

JAX build of the Oceananigans simulation layer the reference examples use
(SURVEY.md O10: ``Simulation``, ``run!``, ``Callback``, ``IterationInterval``,
``TimeInterval``, ``TimeStepWizard(cfl=0.3, max_change=1.1, max_Δt)``;
``examples/bickley_jet.jl:73-89``).

The driver is a thin Python loop around the jitted ``step``; Δt is a *traced* scalar
argument so adapting it never recompiles. Device synchronization happens only when a
callback actually fires (the reference's progress printout every 10 iterations —
``examples/bickley_jet.jl:84-87``); between callbacks the step chain stays fully
asynchronous on device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import jax
import jax.numpy as jnp

from ..models.hydrostatic import HydrostaticModel, State, compute_cfl_dt, multi_step, step

__all__ = [
    "IterationInterval",
    "TimeInterval",
    "TimeStepWizard",
    "Simulation",
    "progress_callback",
    "NaNChecker",
    "Checkpointer",
]


class IterationInterval:
    """Fires every N iterations (Oceananigans IterationInterval)."""

    def __init__(self, every: int):
        self.every = int(every)

    def __call__(self, iteration: int, t: float) -> bool:
        return iteration % self.every == 0


class TimeInterval:
    """Fires whenever simulated time crosses a multiple of ``interval`` seconds
    (Oceananigans TimeInterval)."""

    def __init__(self, interval: float):
        self.interval = float(interval)
        self._next = 0.0

    def __call__(self, iteration: int, t: float) -> bool:
        if t + 1e-9 >= self._next:
            self._next = (t // self.interval + 1) * self.interval
            return True
        return False

    def align(self, t: float) -> None:
        """Re-anchor to the current model time (a resumed run must not fire an
        immediate off-schedule event just because ``_next`` started at 0)."""
        self._next = (t // self.interval + 1) * self.interval if t > 0 else 0.0


@dataclasses.dataclass
class TimeStepWizard:
    """CFL-based Δt adaptation: new Δt = min(max_change·Δt, cfl-limited Δt, max_dt)
    (reference usage ``TimeStepWizard(cfl=0.3, max_change=1.1, max_Δt=3hours)``,
    examples/bickley_jet.jl:75)."""

    cfl: float = 0.3
    max_change: float = 1.1
    min_change: float = 0.5
    max_dt: float = float("inf")

    def update(self, model, state, old_dt: float) -> float:
        from ..models.layered import LayeredModel, layered_cfl_dt

        cfl_fn = layered_cfl_dt if isinstance(model, LayeredModel) else compute_cfl_dt
        cfl_dt = float(cfl_fn(model, state, cfl=self.cfl))
        new_dt = min(self.max_change * old_dt, cfl_dt)
        new_dt = max(new_dt, self.min_change * old_dt)
        return min(new_dt, self.max_dt)


def progress_callback(log=print):
    """The reference's progress printout: time, Δt, max velocities
    (examples/bickley_jet.jl:84-87)."""

    def cb(sim: "Simulation"):
        s = sim.state
        umax = float(jnp.max(jnp.abs(s.u)))
        vmax = float(jnp.max(jnp.abs(s.v)))
        log(
            f"iter {int(sim.iteration):6d}  t={sim.time/86400.0:9.3f} d  "
            f"dt={sim.dt:8.1f} s  velocity: {umax:.2e} {vmax:.2e}"
        )

    return cb


class NaNChecker:
    """Abort the run when a prognostic goes non-finite — Oceananigans installs this
    on every simulation by default (its ``NaNChecker`` on the velocities, every 100
    iterations); so does ``Simulation`` here (disable with ``nan_checker=False``)."""

    def __init__(self, fields=("u",)):
        self.fields = tuple(fields)

    def __call__(self, sim: "Simulation"):
        for name in self.fields:
            arr = getattr(sim.state, name)
            if not bool(jnp.all(jnp.isfinite(arr))):
                raise RuntimeError(
                    f"time step aborted: non-finite values in '{name}' at "
                    f"iteration {sim.iteration}, t = {sim.time:.1f} s")


class Checkpointer:
    """Periodic checkpoint callback (the Oceananigans ``Checkpointer``): writes
    iteration-stamped state checkpoints ``{prefix}_iteration{N}.npz`` (or orbax
    directories without the ``.npz`` suffix). ``Checkpointer.latest(prefix)`` finds
    the newest one for ``Simulation.run(pickup=...)``."""

    def __init__(self, prefix: str, npz: bool = True):
        self.prefix = str(prefix)
        self.npz = bool(npz)

    def path_for(self, iteration: int) -> str:
        return f"{self.prefix}_iteration{iteration}" + (".npz" if self.npz else "")

    def __call__(self, sim: "Simulation"):
        from .checkpoint import save_checkpoint

        save_checkpoint(self.path_for(sim.iteration), sim.state)

    @staticmethod
    def latest(prefix: str):
        """Newest checkpoint path for ``prefix`` (by iteration number), or None."""
        import glob
        import re

        best, best_it = None, -1
        # escape glob metacharacters in the prefix; anchor the iteration number to
        # the END of the name so "_iteration<N>" elsewhere in the path is ignored
        for p in glob.glob(glob.escape(prefix) + "_iteration*"):
            m = re.search(r"_iteration(\d+)(?:\.npz)?$", p)
            if m and int(m.group(1)) > best_it:
                best, best_it = p, int(m.group(1))
        return best


class Simulation:
    """Python driver around the jitted step function.

    Callbacks are (schedule, fn) pairs; ``fn(sim)`` runs on the host and may read the
    state (triggering a device sync) or mutate ``sim.dt`` (the TimeStepWizard path).
    Output writers attach the same way.
    """

    def __init__(self, model, state, dt: float,
                 stop_time: float = float("inf"), stop_iteration: int = 2**62,
                 steps_per_block: int = 1, nan_checker: bool = True):
        from ..models.layered import LayeredModel, layered_multi_step, layered_step

        self.model = model
        self.state = state
        self.dt = float(dt)
        self.stop_time = float(stop_time)
        self.stop_iteration = int(stop_iteration)
        self.callbacks: list[tuple[Any, Callable]] = []
        if nan_checker:
            self.add_callback(NaNChecker(), IterationInterval(100))
        is_layered = isinstance(model, LayeredModel)
        self._step = jax.jit(layered_step if is_layered else step)
        # multi-step blocks amortize per-dispatch overhead; schedules still fire at
        # block boundaries, so pick steps_per_block <= the smallest callback interval
        self.steps_per_block = int(steps_per_block)
        if self.steps_per_block > 1:
            import functools

            self._multi = jax.jit(functools.partial(
                layered_multi_step if is_layered else multi_step,
                n_steps=self.steps_per_block))
        self.wall_start = None

    @property
    def iteration(self) -> int:
        return int(self.state.iteration)

    @property
    def time(self) -> float:
        return float(self.state.t)

    def add_callback(self, fn: Callable, schedule) -> None:
        self.callbacks.append((schedule, fn))

    def run(self, pickup=None) -> State:
        """The reference's ``run!`` loop (examples/bickley_jet.jl:89).

        ``pickup``: a checkpoint path (or True to auto-find the newest one written by
        an attached ``Checkpointer``) — the state is restored before stepping, the
        Oceananigans ``run!(sim, pickup=true)`` semantics."""
        if pickup:
            from .checkpoint import load_checkpoint

            path = pickup
            if pickup is True:
                for _, fn in self.callbacks:
                    if isinstance(fn, Checkpointer):
                        path = Checkpointer.latest(fn.prefix)
                        break
                if path is True or path is None:
                    raise ValueError("pickup=True needs an attached Checkpointer "
                                     "with at least one written checkpoint")
            self.state = load_checkpoint(path, self.state)
            # re-anchor time-based schedules to the restored time so resumed runs
            # produce the same event sequence as uninterrupted ones
            for schedule, _ in self.callbacks:
                align = getattr(schedule, "align", None)
                if callable(align):
                    align(self.time)
        self.wall_start = time.time()
        it = self.iteration
        t = self.time
        try:
            while t < self.stop_time and it < self.stop_iteration:
                nb = self.steps_per_block
                remaining = self.stop_time - t
                if nb > 1 and remaining >= nb * self.dt and it + nb <= self.stop_iteration:
                    self.state = self._multi(self.model, self.state, self.dt)
                    it += nb
                    t += nb * self.dt
                else:
                    # don't overshoot stop_time
                    dt = min(self.dt, max(remaining, 1e-12)) if self.stop_time < float("inf") else self.dt
                    self.state = self._step(self.model, self.state, dt)
                    it += 1
                    t += dt
                for schedule, fn in self.callbacks:
                    if schedule(it, t):
                        fn(self)
            jax.block_until_ready(self.state)
        finally:
            # drain async output writers even on an exception / KeyboardInterrupt
            # mid-run, so queued snapshots reach disk before the thread dies
            for _, fn in self.callbacks:
                close = getattr(fn, "close", None)
                if callable(close):
                    close()
        return self.state
