"""mfu.serve: the forward's convolutions of the images completed in the
traced window, each at the peak of the precision it runs in (int8
convolutions at 1,979 TOP/s, the bf16 ones at 989 TFLOP/s, NVIDIA H100 SXM
at 700 W), over the window's seconds, in %."""

import counts


def read(m):
    if not m.images or m.trace.window_s <= 0:
        return None
    return 100.0 * counts.forward_peak_s(m.cfg) * m.images / m.trace.window_s
