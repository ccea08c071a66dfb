"""route_ms_per_mpt (host routing, host clock): host milliseconds inside
pcr_tpu_torch.engine.routing.assign per million points it assigned, in
the traced window (the harness wraps the function there)."""


def read(run):
    if not run.route_points:
        return None
    return run.route_s * 1e3 / (run.route_points / 1e6)
