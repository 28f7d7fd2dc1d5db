"""``rescore_pairs_per_query`` in the cells whose rate the host paces too
unsteadily for a bound: (query, row) pairs the host rescored exactly per
query served over the window (``RecallEngine.stats``)."""

from recall_bench import measure


def read(run):
    return measure.per_query(run.stats0, run.stats1, "rescore_pairs_total")
