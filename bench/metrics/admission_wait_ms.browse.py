"""Mean ms a browse request waits in admission before it is seated
(``AdmissionStats.total_wait_s / served`` from the window's start to the
profiler's, real clock)."""


def read(run) -> float | None:
    served = run.admission["served"]
    return 1e3 * run.admission["total_wait_s"] / served if served else None
