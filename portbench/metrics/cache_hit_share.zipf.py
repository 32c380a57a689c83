"""Result-cache hits over lookups, in %, on the service's submit path over
the window (a saturating loop: hits are answered at submit, beside the
waves of the misses)."""


def read(run):
    hits, misses = run.telemetry["cache_hits"], run.telemetry["cache_misses"]
    return None if hits + misses == 0 else 100.0 * hits / (hits + misses)
