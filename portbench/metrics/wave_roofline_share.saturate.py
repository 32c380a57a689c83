"""Share of the HBM roofline in the device time of a wave: the least time
of the bytes the wave's work needs (``peaks.wave_bytes``) at 3.35 TB/s over
the traced device-busy seconds per wave of the window."""
from portbench.peaks import roofline_pct, wave_bytes


def read(run):
    waves = run.telemetry.get("waves") or 0
    if run.device is None or not waves or run.device["busy_s"] <= 0:
        return None
    need = wave_bytes(run.num_vertices, run.num_edges, run.num_dangling,
                      run.kappa, run.iterations, run.k)
    return roofline_pct(need, run.device["busy_s"] / waves)
