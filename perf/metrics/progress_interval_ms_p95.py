"""95th percentile of the wall time between consecutive progress lines of the
simulation loop over the window, in ms: the wait of a user watching the run."""

import numpy as np


def read(ctx):
    times = ctx.window.get("progress_times") or []
    if len(times) < 2:
        return None
    return float(np.percentile(np.diff(times), 95)) * 1e3
