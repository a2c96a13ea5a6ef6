"""Host side of the convolutions' kernels: which kernel instance and which
output-channel tile a conv takes.

``csrc/igemm_sm90.cuh`` computes 128 x BN output tiles (128 output pixels by
BN output channels). BN is chosen here from Cout, so that a narrow conv does
not idle most of every tensor-core instruction; the instance is chosen from
Cin, Cout, the kernel size and the operands' alignment. The C entry points
check the same conditions and refuse an instance that does not fit, so a
wrong pick raises instead of computing garbage.
"""

from __future__ import annotations

BM = 128                       # output pixels per CTA
BN_TILES = (256, 128, 64, 32)  # output channels per CTA
# the direct first-conv kernel (Cin = 3; mma.sync on a tile of output
# pixels, csrc/conv_int8.cu): kernel size -> the most output channels one
# instance takes
DIRECT_MAX_COUT = {3: 32, 7: 64}
# instance names, and the codes the C entry points take
INSTANCES = {"gather": 0, "wgmma": 1, "direct": 2}


def pick_bn(cout: int, elem_bytes: int) -> int:
    """The narrowest of the 32, 64 and 128 wide tiles that covers Cout, else
    128; 256 for bf16 (``elem_bytes`` 2) from Cout = 256 on. A 256-wide tile
    reads its A tile half as often, which pays where shared-memory fills, not
    the tensor cores, set the pace: on an H100 that is bf16's deep layers,
    while int8, with twice the products per byte, gained nothing from it."""
    if elem_bytes == 2 and cout >= 256:
        return 256
    for bn in (32, 64):
        if cout <= bn:
            return bn
    return 128


def pick_instance(cin: int, cout: int, ksize: int, elem_bytes: int,
                  aligned: bool, out_chunk: int = 8) -> str:
    """``direct``: the first conv of a network (Cin = 3, 3x3 with Cout <=
    32 or 7x7 with Cout <= 64, in whole 16-byte stores: a multiple of
    ``out_chunk``, 16 for int8 out), its input staged a word (R, G, B, 0) a
    pixel for mma.sync (``conv_int8.plan`` sends a stride whose input patch
    would not fit its shared memory to ``gather``). ``wgmma``: the cp.async ring,
    which copies 16 bytes of one tap at a time, so a pixel's Cin elements
    (``elem_bytes`` each) must fill whole 16-byte chunks and the operands
    (``aligned``) must start on one. ``gather``: every other conv, the same
    ring filled element by element."""
    if (cin == 3 and cout <= DIRECT_MAX_COUT.get(ksize, 0)
            and cout % out_chunk == 0):
        return "direct"
    if aligned and (cin * elem_bytes) % 16 == 0:
        return "wgmma"
    return "gather"
