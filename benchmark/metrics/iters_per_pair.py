"""Solver iterations of each finished pair, over the window: the
iteration counts the port reports (``register_pair``'s stats)."""


def read(run):
    pairs = run.counters.get("pairs_finished", 0.0)
    if pairs <= 0:
        return None
    return run.counters["iters_finished"] / pairs
