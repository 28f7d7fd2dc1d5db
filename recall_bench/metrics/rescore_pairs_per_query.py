"""(query, row) pairs the host rescored exactly, per query served, over the
window (``RecallEngine.stats`` ``rescore_pairs_total`` / ``searches_total``)."""

from recall_bench import measure


def read(run):
    return measure.per_query(run.stats0, run.stats1, "rescore_pairs_total")
