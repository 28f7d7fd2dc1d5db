"""95th percentile of the latency of every request answered inside the
window, from its submission to its answer, in ms. Per-layer: the host
paces it (the coalescer's batches, the interpreter's collector pauses), and
its run-to-run spread is too wide for an end-to-end bound."""

from recall_bench import measure


def read(run):
    return 1e3 * measure.percentile(run.latencies, 95.0) if run.completed else None
