"""Mean host milliseconds of a wave's ``iterate`` stage (the service's
telemetry over the window's waves): with no early exit nothing syncs there,
so this is the host's enqueue of the iterations."""


def read(run):
    st = run.stages.get("iterate")
    return None if not st or not st["count"] else st["mean_s"] * 1e3
