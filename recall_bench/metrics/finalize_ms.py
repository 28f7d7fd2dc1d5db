"""Host ms of one ``RecallEngine._finalize_device_batch`` call (the native
keyword rescore, ``finish_cosines``, ``_dd_certify_batch``, the rescue; on
an f32 index also the xla scan): every call the window started, their total over their count."""

from recall_bench import spans


def read(run):
    return spans.mean_ms(run, "finalize")
