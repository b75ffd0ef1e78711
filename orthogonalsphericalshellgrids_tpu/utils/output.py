"""Output writing and time-series reading.

JAX equivalent of the reference's ``JLD2OutputWriter`` + ``FieldTimeSeries``
pair (SURVEY.md O11; ``examples/bickley_jet.jl:79-82, :92-93``): periodic field dumps
with an optional ``with_halos`` flag, and a reader that loads the dump back as arrays
with times.

Container format: a zip of ``.npy`` members (``numpy.load``-compatible), one member
per field per snapshot (``c.000004.npy``), appended in O(snapshot) time — the
JLD2-style append without rewriting history. Writes optionally run on a background
thread (``async_write=True``) so compression/disk IO overlaps the simulation's device
compute — the double-buffered output path of a production run.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
import zipfile
from typing import Callable

import numpy as np

__all__ = ["OutputWriter", "ShardedOutputWriter", "NetCDFWriter", "FieldTimeSeries",
           "read_netcdf_series"]


def _append_snapshot(filename: str, k: int, t: float, arrs: dict, compression) -> None:
    """Append one snapshot (all fields + the time stamp) to a zip-of-npy archive."""
    with zipfile.ZipFile(filename, "a", compression=compression) as z:
        for name, arr in arrs.items():
            with z.open(f"{name}.{k:06d}.npy", "w") as f:
                np.lib.format.write_array(f, np.ascontiguousarray(arr))
        with z.open(f"times.{k:06d}.npy", "w") as f:
            np.lib.format.write_array(f, np.asarray(t))


class OutputWriter:
    """Periodic field dumps: attach to a Simulation with a schedule.

    ``outputs`` maps name -> callable(sim) -> array (device arrays are pulled to host).
    Mirrors the reference writer usage (fields + derived diagnostics like ζ,
    examples/bickley_jet.jl:79-82). ``with_halos=False`` crops to the interior using
    the model's base (or extended) grid. ``async_write=True`` moves compression and
    disk IO to a writer thread; call ``close()`` (or rely on the Simulation's run end)
    to drain it.
    """

    def __init__(self, filename: str, outputs: dict[str, Callable], with_halos: bool = False,
                 overwrite_existing: bool = True, async_write: bool = False,
                 compress: bool = True):
        self.filename = filename
        self.outputs = outputs
        self.with_halos = with_halos
        self._count = 0
        self._compression = zipfile.ZIP_DEFLATED if compress else zipfile.ZIP_STORED
        if overwrite_existing and os.path.exists(filename):
            os.remove(filename)
        elif os.path.exists(filename):
            # appending to an existing archive: continue numbering after the last
            # snapshot already present (duplicate member names would make np.load
            # silently keep one entry per name and scramble the series)
            with zipfile.ZipFile(filename) as z:
                idx = [int(n.split(".")[-2]) for n in z.namelist()
                       if n.startswith("times.") and n.endswith(".npy")]
            self._count = max(idx) + 1 if idx else 0
        self._error: BaseException | None = None
        self._queue: queue.Queue | None = None
        self._worker: threading.Thread | None = None
        if async_write:
            self._queue = queue.Queue(maxsize=4)  # bounded: backpressure, not OOM
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # -- capture ------------------------------------------------------------------

    def __call__(self, sim) -> None:
        g = sim.model.grid
        arrs = {}
        for name, fn in self.outputs.items():
            arr = np.asarray(fn(sim))
            if not self.with_halos and arr.shape == g.shape2d:
                arr = arr[g.interior2d]
            elif not self.with_halos and arr.shape == sim.model.grid_ext.shape2d:
                ge = sim.model.grid_ext
                arr = arr[ge.interior2d]
            arrs[name] = arr
        self._raise_pending()
        job = (self._count, float(sim.time), arrs)
        self._count += 1
        if self._queue is not None:
            self._queue.put(job)
        else:
            self._write(job)

    # -- writing ------------------------------------------------------------------

    def _write(self, job) -> None:
        k, t, arrs = job
        _append_snapshot(self.filename, k, t, arrs, self._compression)

    def _drain(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                self._queue.task_done()
                return
            try:
                if self._error is None:  # after a failure, drop (don't corrupt) jobs
                    self._write(job)
            except BaseException as e:  # noqa: BLE001 — surfaced via _raise_pending
                if self._error is None:
                    self._error = e
            finally:
                # task_done unconditionally: a failed _write must not deadlock
                # close()/queue.join()
                self._queue.task_done()

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async OutputWriter for {self.filename!r} failed") from err

    def close(self) -> None:
        """Drain the async writer (no-op for synchronous writers); re-raises the
        first error the writer thread hit, if any."""
        if self._queue is not None:
            self._queue.join()
        self._raise_pending()

    flush = close  # backward-compatible alias


class ShardedOutputWriter:
    """Per-shard field dumps for distributed runs (SURVEY.md O11's distributed half —
    the reference writes one JLD2 file per MPI rank,
    examples/distributed_bickley_jet.jl:83-87).

    Each snapshot writes one archive per shard, ``<stem>.rank<k><ext>``, holding only
    that shard's interior block pulled from its *addressable* device shard — the
    global array is never materialized on the host. On a real multi-host pod each
    controller sees (and writes) only its own devices' shards, so output IO scales
    with the number of hosts. ``FieldTimeSeries`` stitches the rank files back into
    global interiors transparently.

    ``outputs`` maps name -> callable(sim) -> *sharded* jax array in the distributed
    stacked layout (parallel/distributed.py: per-shard halo-inclusive row blocks);
    ``dist_model`` supplies the local-size metadata used to crop each block to its
    interior. ``write(t, arrays)`` is the direct entry point for hand-rolled loops.
    """

    def __init__(self, filename: str, outputs: dict[str, Callable], dist_model,
                 overwrite_existing: bool = True, compress: bool = True):
        self.outputs = outputs
        self.dist_model = dist_model
        self._compression = zipfile.ZIP_DEFLATED if compress else zipfile.ZIP_STORED
        stem, ext = os.path.splitext(filename)
        self._stem, self._ext = stem, ext or ".npz"
        self._count = 0
        existing = sorted(glob.glob(f"{stem}.rank*{self._ext}"))
        if overwrite_existing:
            for f in existing:
                os.remove(f)
        elif existing:
            with zipfile.ZipFile(existing[0]) as z:
                idx = [int(n.split(".")[-2]) for n in z.namelist()
                       if n.startswith("times.") and n.endswith(".npy")]
            self._count = max(idx) + 1 if idx else 0

    def rank_filename(self, k: int) -> str:
        return f"{self._stem}.rank{k}{self._ext}"

    def __call__(self, sim) -> None:
        self.write(float(sim.time), {name: fn(sim) for name, fn in self.outputs.items()})

    def write(self, t: float, arrays: dict) -> None:
        """Append one snapshot: crop every addressable shard's block to its interior
        and append it to that shard's archive."""
        g = self.dist_model.grid  # local metadata: Ny is the per-shard row count
        per_rank: dict[int, dict] = {}
        for name, a in arrays.items():
            for shard in a.addressable_shards:
                block = np.asarray(shard.data)
                row_axis = block.ndim - 2
                start = shard.index[row_axis].start or 0
                block_rows = block.shape[row_axis]
                k = start // block_rows
                # halo widths fall out of the block arithmetic exactly: a base-halo
                # leaf has block_rows = ny + 2*Hy, an extended-halo leaf
                # ny + 2*Hy_ext — either way the interior is the centered ny rows.
                hy = (block_rows - g.Ny) // 2
                hx = (block.shape[-1] - g.Nx) // 2
                sl = [slice(None)] * block.ndim
                sl[row_axis] = slice(hy, hy + g.Ny)
                sl[-1] = slice(hx, hx + g.Nx)
                per_rank.setdefault(k, {})[name] = block[tuple(sl)]
        for k, arrs in sorted(per_rank.items()):
            _append_snapshot(self.rank_filename(k), self._count, t, arrs,
                             self._compression)
        self._count += 1

    def close(self) -> None:  # symmetric with OutputWriter for Simulation draining
        pass


class NetCDFWriter:
    """NetCDF output (the ecosystem's ``NetCDFOutputWriter`` analog; the reference's
    examples use JLD2, SURVEY.md O11, but NetCDF is the interchange format ocean
    users expect). Writes NetCDF3-classic/64-bit-offset via ``scipy.io.netcdf_file``
    (no extra dependencies): one UNLIMITED ``time`` dimension, one record variable
    per output, plus ``lam_cc``/``phi_cc`` coordinate variables for base-interior
    2-D fields. Attach to a Simulation with a schedule, like OutputWriter."""

    def __init__(self, filename: str, outputs: dict[str, Callable],
                 with_halos: bool = False):
        self.filename = filename
        self.outputs = outputs
        self.with_halos = with_halos
        self._nc = None
        self._k = 0

    def _crop(self, sim, arr):
        g = sim.model.grid
        if not self.with_halos and arr.shape[-2:] == g.shape2d:
            return arr[..., g.interior2d[0], g.interior2d[1]]
        ge = sim.model.grid_ext
        if not self.with_halos and arr.shape[-2:] == ge.shape2d:
            return arr[..., ge.interior2d[0], ge.interior2d[1]]
        return arr

    def _create(self, sim, arrs) -> None:
        from scipy.io import netcdf_file

        nc = netcdf_file(self.filename, "w", version=2)  # 64-bit offset
        nc.createDimension("time", None)
        tv = nc.createVariable("time", "d", ("time",))
        tv.units = b"seconds"

        def dim_for(hint, n):
            name = f"{hint}{n}"
            if name not in nc.dimensions:
                nc.createDimension(name, n)
            return name

        coords_dims = None
        g = sim.model.grid
        for name, a in arrs.items():
            hints = ["z", "y", "x"][-a.ndim:]
            dims = tuple(dim_for(h, s) for h, s in zip(hints, a.shape))
            nc.createVariable(name, "f" if a.dtype == np.float32 else "d",
                              ("time",) + dims)
            if a.shape[-2:] == (g.Ny, g.Nx):
                coords_dims = dims[-2:]
        if coords_dims is not None:
            lam = np.asarray(g.lam_cc, np.float64)[g.interior2d]
            phi = np.asarray(g.phi_cc, np.float64)[g.interior2d]
            for cname, cval in (("lam_cc", lam), ("phi_cc", phi)):
                cv = nc.createVariable(cname, "d", coords_dims)
                cv.units = b"degrees"
                cv[:] = cval
        self._nc = nc

    def __call__(self, sim) -> None:
        arrs = {name: self._crop(sim, np.asarray(fn(sim)))
                for name, fn in self.outputs.items()}
        if self._nc is None:
            self._create(sim, arrs)
        nc = self._nc
        nc.variables["time"][self._k] = float(sim.time)
        for name, a in arrs.items():
            nc.variables[name][self._k] = a
        self._k += 1
        nc.sync()

    def close(self) -> None:
        if self._nc is not None:
            self._nc.close()
            self._nc = None


def read_netcdf_series(filename: str, name: str):
    """(times, values) from a NetCDFWriter file — values shaped (time, ...)."""
    from scipy.io import netcdf_file

    with netcdf_file(filename, "r", mmap=False) as nc:
        return (np.array(nc.variables["time"][:]),
                np.array(nc.variables[name][:]))


class FieldTimeSeries:
    """Reader for OutputWriter dumps (the reference's FieldTimeSeries,
    examples/bickley_jet.jl:92-93): ``fts = FieldTimeSeries(path, "c")``;
    ``fts.times``, ``fts[i]``, ``len(fts)``.

    Also reads ShardedOutputWriter output: pass the base filename (no ``.rank<k>``)
    and the per-rank interiors are stitched along the row axis in rank order."""

    def __init__(self, filename: str, name: str):
        if not os.path.exists(filename):
            stem, ext = os.path.splitext(filename)
            ranks = sorted(glob.glob(f"{stem}.rank*{ext or '.npz'}"),
                           key=lambda f: int(f[len(stem) + 5 : -len(ext or '.npz')]))
            if not ranks:
                raise FileNotFoundError(filename)
            parts = [FieldTimeSeries(f, name) for f in ranks]
            self.times = parts[0].times
            for p in parts[1:]:
                np.testing.assert_allclose(p.times, self.times, err_msg=(
                    "per-rank archives have mismatched snapshot times"))
            # stacked per-rank interiors -> global interior rows
            self._data = np.concatenate([p._data for p in parts], axis=-2)
            return
        with np.load(filename) as data:
            tkeys = sorted(k for k in data.files if k.startswith("times."))
            self.times = np.asarray([float(data[k]) for k in tkeys])
            fkeys = sorted(k for k in data.files if k.startswith(name + "."))
            if len(fkeys) != len(tkeys):
                raise KeyError(f"field {name!r} has {len(fkeys)} snapshots, "
                               f"expected {len(tkeys)}")
            self._data = np.stack([data[k] for k in fkeys]) if fkeys else np.zeros((0,))

    def __len__(self):
        return len(self.times)

    def __getitem__(self, i):
        return self._data[i]

    @property
    def data(self):
        return self._data
