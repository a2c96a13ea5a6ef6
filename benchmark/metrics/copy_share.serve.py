"""copy_share.serve: the share of the traced window in which a copy runs
on the device and no kernel does, in %: the host batch's trip to the card
that nothing overlaps (pipeline.Detector._run)."""


def read(m):
    t = m.trace
    if not t.copies or t.window_s <= 0:
        return None
    return 100.0 * t.copy_only_s() / t.window_s
