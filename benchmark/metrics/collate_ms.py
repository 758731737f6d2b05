"""Host time of one collate (``build_pair_pyramid``) in a worker thread,
over the window's collates."""


def read(run):
    n = run.counters.get("collates", 0.0)
    if n <= 0:
        return None
    return 1e3 * run.counters["collate_s"] / n
