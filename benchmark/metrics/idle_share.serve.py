"""idle_share.serve: the share of the traced serving window in which no
kernel, copy or set runs on the device, in %."""


def read(m):
    t = m.trace
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
