"""The plain-torch scan's share of its roofline: over every
``ops/xla_scorer.py score_topm`` call in the traced span, the least time
the card could take for its cosine product (the larger of 2·N·d·B f32
operations at 67 TFLOP/s, TF32 off, and the f32 rows and bloom bytes at
3.35 TB/s) over the device time of the kernels the call launched."""

from recall_bench import measure


def read(run):
    calls = [s for s in run.trace.in_window("xla_scan") if s.kernels] if run.trace else []
    if not calls:
        return None
    bound = sum(measure.bound_s(*measure.xla_scan_work(
        s.shapes["n"], s.shapes["d"], s.shapes["b"], s.shapes["w"]), "f32") for s in calls)
    return 100.0 * bound / sum(s.device_s for s in calls)
