"""K1's share of its roofline over the traced span: the least time the
card could take for each K1 launch (the larger of 2·N·d·B int8 operations
at 1979 TOP/s and K1's input and output bytes at 3.35 TB/s, from the shapes
of the span's ``block_topt_int8_coarse`` calls) over the device time of
the K1 kernels (``int8_scan_kernel`` with K1's ``CoarseArgs``) that ran in
the span."""

from recall_bench import measure

K1_KERNEL = "CoarseArgs"


def read(run):
    if run.trace is None:
        return None
    lo, hi = run.trace.window
    k1 = [(s, e) for s, e, name in run.trace.device if K1_KERNEL in name and lo <= s < hi]
    calls = run.trace.in_window("k1")
    if not k1 or not calls:
        return None
    bound = sum(measure.bound_s(*measure.coarse_scan_work(
        c.shapes["n"], c.shapes["d"], c.shapes["b"], c.shapes["sub"], c.shapes["t"]), "int8")
        for c in calls) / len(calls)
    return 100.0 * bound * len(k1) / sum(e - s for s, e in k1)
