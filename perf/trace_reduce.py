"""Reduce a profiler trace (``.xplane.pb``) to what the per-layer metrics read.

The card's work is on the planes named ``/device:GPU:<n>``, one line per CUDA
stream, one event per kernel or copy, with start and duration in nanoseconds on
the same clock as the host planes. The harness's host spans are
``TraceAnnotation`` events on the host plane (``/host:CPU``), on the line of the
thread that opened them. The traced window is the host span ``window_span``.

Reduced:
- ``busy_s``: the union of all device events inside the window, averaged over the
  devices;
- ``window_s``: the window's length;
- ``ops``: device seconds per op name, the launch index (``__<n>``) that the
  Pallas / Triton lowering appends to repeated kernels folded into one name;
- ``gaps``: idle intervals of the device inside the window, each with the
  harness span open on the host at its midpoint (``"loop"`` when none is).
"""

from __future__ import annotations

import collections
import glob
import os
import re

_LAUNCH = re.compile(r"__\d+$")


def op_name(name):
    return _LAUNCH.sub("", name)


def latest_xplane(log_dir):
    paths = sorted(glob.glob(os.path.join(log_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    return paths[-1]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_planes(planes, window_span, span_names):
    """``planes``: iterable of (plane_name, [(line_name, [(name, start_ns,
    end_ns), ...]), ...]). ``span_names``: the harness's host span names."""
    window = None
    host_spans = []
    devices = []
    for pname, lines in planes:
        if pname.startswith("/device:GPU:"):
            devices.append([ev for _, evs in lines for ev in evs])
        elif pname == "/host:CPU":
            for _, evs in lines:
                for name, s, e in evs:
                    if name == window_span:
                        window = (s, e)
                    elif name in span_names:
                        host_spans.append((name, s, e))
    if window is None:
        raise ValueError(f"host span {window_span!r} not in the trace")
    if not devices:
        raise ValueError("no /device:GPU plane in the trace")
    w0, w1 = window
    ops = collections.defaultdict(float)
    busy_total = 0.0
    gaps = []
    for evs in devices:
        inside = [(max(s, w0), min(e, w1), n) for n, s, e in evs if e > w0 and s < w1]
        for s, e, n in inside:
            ops[op_name(n)] += (e - s) * 1e-9
        merged = _union([(s, e) for s, e, _ in inside])
        busy_total += sum(e - s for s, e in merged)
        edges = [w0] + [x for iv in merged for x in iv] + [w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((a, b))
    host_spans.sort(key=lambda t: t[2] - t[1])  # innermost (shortest) span first

    def doing(t):
        for name, s, e in host_spans:
            if s <= t <= e:
                return name
        return "loop"

    gaps = sorted(((doing(0.5 * (a + b)), (b - a) * 1e-9) for a, b in gaps),
                  key=lambda g: -g[1])
    return {"busy_s": busy_total * 1e-9 / len(devices), "window_s": (w1 - w0) * 1e-9,
            "ops": dict(ops), "gaps": gaps, "devices": len(devices)}


def planes_of(path):
    """The trace at ``path`` as plain tuples (see ``reduce_planes``)."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    return [(p.name, [(ln.name, [(e.name, e.start_ns, e.end_ns) for e in ln.events])
                      for ln in p.lines]) for p in pd.planes]


def reduce_trace(path, window_span, span_names):
    return reduce_planes(planes_of(path), window_span, span_names)


def breakdown(red, top=10):
    """The result line's ``breakdown``: device ops by time, longest idle gaps."""
    ops = sorted(red["ops"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in red["gaps"][:top]]}
