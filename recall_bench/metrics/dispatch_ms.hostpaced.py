"""``dispatch_ms`` in the cells whose rate the host paces too unsteadily for
a bound: host ms of one ``RecallEngine._dispatch_device_batch`` call, every
call the window started, their total over their count."""

from recall_bench import spans


def read(run):
    return spans.mean_ms(run, "dispatch")
