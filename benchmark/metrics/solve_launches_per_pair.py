"""C5 launches (``ldmk_iteration_kernel``) inside the port's ``dp::solve``
span, a pair, in the profiled slice: one a call of a level loop's step,
the applied iterations and the no-ops after the stop alike (against
``solve_noops_per_pair`` of the same pairs)."""
from benchmark import program_spans


def read(run):
    if run.trace is None:
        return None
    return program_spans.launches(run.trace, "dp::solve",
                                  kernel="ldmk_iteration_kernel")
