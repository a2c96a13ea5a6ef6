"""conv_int8_roofline: the int8 convolutions' bound (each the larger of
its operations at 1,979 TOP/s and its bytes at 3.35 TB/s, bf16 in and out,
``counts.int8_bound_s``) for the forwards of the traced window, over the
device time of the int8 convolution's kernels there, in %."""

import counts

# the kernels of ops/kernels/conv_int8 (csrc/conv_int8.cu): the quantize
# pass, the wgmma GEMM and the direct first convolution
KERNELS = ("quantize_act", "conv_int8_wgmma", "conv_int8_direct")


def read(m):
    busy = m.trace.kernel_s(lambda n: any(k in n for k in KERNELS))
    if busy <= 0 or not m.images:
        return None
    batch = m.traffic["batch"]
    bound = counts.int8_bound_s(m.cfg, batch)["total"] * m.images / batch
    return 100.0 * bound / busy
