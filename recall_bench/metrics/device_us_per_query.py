"""The card's busy time per query answered, in microseconds, over the whole
window: the union of every kernel, copy and set on the card between the
window's two ends (``torch.profiler``'s CUDA activity, traced over the
window itself) over the queries answered in it. What a query costs the
card, whatever the host's pace."""


def read(run):
    if run.trace is None or not run.trace_is_window or not run.completed:
        return None
    return 1e6 * run.trace.busy_s() / run.completed
