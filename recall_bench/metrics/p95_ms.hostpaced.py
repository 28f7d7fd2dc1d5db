"""``p95_ms`` in the cells whose rate the host paces too unsteadily for a
bound (their bounded metric is ``device_us_per_query``): the 95th
percentile of the latency of every request answered inside the window, in ms."""

from recall_bench import measure


def read(run):
    return 1e3 * measure.percentile(run.latencies, 95.0) if run.completed else None
