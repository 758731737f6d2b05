"""Host time the main thread waited for the next collated pair, per
pair dispatched in the window."""


def read(run):
    waits = run.spans.get("collate_wait", [])
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
