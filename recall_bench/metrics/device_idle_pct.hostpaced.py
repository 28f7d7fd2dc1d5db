"""``device_idle_pct`` in the cells whose rate the host paces too unsteadily
for a bound: percent of the traced span in which no kernel, copy or set ran
on the card."""

from recall_bench import measure


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return measure.idle_share(run.trace.busy_s(), run.trace.window_s)
