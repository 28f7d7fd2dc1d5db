"""``certified_qps`` in the cells whose rate the host paces too unsteadily
for a bound (their bounded metric is ``device_us_per_query``): queries
answered over the whole window's time, read in the traced run, whose
window holds the benchmark's timers and no profiler."""

from recall_bench import measure


def read(run):
    return measure.rate(run.completed, run.window_s)
