"""Whole runs with the timed path broken underneath (the harness's look
for a card skipped, the port's plain versions on the CPU): each fault a
served cell can have turns ``correct`` false. One card serves each cell,
so no fault of the exchange between cards applies."""

import pytest

from conftest import ROOT, tiny

CELLS = ["int8-1M-hybrid-c896", "xla-1M-hybrid-c896"]


def wrap_finalize(change):
    def patch(engine):
        finalize = engine._finalize_device_batch

        def broken(ctx):
            return change(finalize(ctx))
        engine._finalize_device_batch = broken
    return patch


def altered(results):
    """An answer altered where it is produced: the first answer's best
    score a hair off (1e-9)."""
    from omni_recall_tpu_torch.search.engine import SearchHit

    h = results[0][0]
    results[0] = [SearchHit(h.chunk, h.score + 1e-9)] + results[0][1:]
    return results


def half_left_out(results):
    """Half of the batch left out: the second half answered with nothing."""
    n = len(results) // 2
    return results[:len(results) - n] + [[] for _ in range(n)]


def half_dropped(results):
    """Half of the batch left out of the finalize's result list."""
    return results[:(len(results) + 1) // 2]


def unchanged(state={}):
    """The state returned unchanged: every batch answered with the first
    batch's answers."""
    def change(results):
        first = state.setdefault("first", results)
        return [first[i % len(first)] for i in range(len(results))]
    return change


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["altered", "half_left_out", "half_dropped", "unchanged"])
def test_fault_is_not_correct(cell, fault):
    from recall_bench import run

    change = {"altered": altered, "half_left_out": half_left_out,
              "half_dropped": half_dropped, "unchanged": unchanged({})}[fault]
    out = run.run(ROOT, tiny(cell), 2**31 + 99, 1.0, False, device="cpu",
                  patch=wrap_finalize(change))
    assert out["correct"] is False, out["checks"]
    failing = [k for k, c in out["checks"].items() if c["value"] > c["limit"]]
    assert failing
