"""device_idle_pct (device, device trace): the share of the traced window
in which no kernel, memcpy or memset ran on the card, in percent: 1 - the
union of their intervals over the window's wall."""


def read(run):
    t = run.trace
    if t is None or not t.window_s or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
