"""Queries answered over the whole window's time (each run's answers are
then held to the reference: a run with any wrong answer is not correct)."""

from recall_bench import measure


def read(run):
    return measure.rate(run.completed, run.window_s)
