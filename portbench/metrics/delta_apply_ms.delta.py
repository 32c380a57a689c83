"""Mean milliseconds of ``apply_delta`` (its own ``apply_s``) over the
window's deltas."""


def read(run):
    return None if not run.apply_s else 1e3 * sum(run.apply_s) / len(run.apply_s)
