"""Mean wave occupancy (queries over kappa), in %, over the window's waves."""


def read(run):
    return None if not run.telemetry.get("waves") else \
        100.0 * run.telemetry["mean_occupancy"]
