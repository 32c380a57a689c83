"""Result-cache hits over lookups, in %, on the service's submit path over
the window."""


def read(run):
    hits, misses = run.telemetry["cache_hits"], run.telemetry["cache_misses"]
    return None if hits + misses == 0 else 100.0 * hits / (hits + misses)
