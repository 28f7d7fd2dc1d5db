"""Host ms of one ``RecallEngine._dispatch_device_batch`` call (query prep,
uploads, launches): every call the window started, their total over their count."""

from recall_bench import spans


def read(run):
    return spans.mean_ms(run, "dispatch")
