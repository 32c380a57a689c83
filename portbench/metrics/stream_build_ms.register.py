"""Host milliseconds registration spent on the fused graph's dst stream:
its build from the COO arrays and its uploads of topology and values (the
service's ``register_stream_s``; None where the service reports none)."""


def read(run):
    s = run.telemetry.get("register_stream_s")
    return None if s is None else s * 1e3
