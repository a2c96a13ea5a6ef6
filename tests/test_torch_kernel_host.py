"""What surrounds the port's kernels on the host, on the CPU: the int8
conv's quantize prologue against the JAX package's, the plain int8 conv as
the sum of its parts, which kernel instance and tile each conv takes, the
decode kernel's tile plan and launch arguments, and the build's bookkeeping.
The CUDA kernels themselves are held to their plain versions on the card by
chip_smoke.py (phases 3, 6, 8 and 14).

- ``quantize_act_plain`` equals, bit for bit, the int8 tensor that
  yolo_tensorflow_tpu/ops/quant.conv2d_int8 hands to its conv (captured at
  ``lax.conv_general_dilated``), on seeded inputs with exact halves (round
  half to even) and values past +-127.
- ``conv2d_int8_plain`` equals the epilogue applied to
  ``int8_accumulate(quantize_act_plain(x))``, exactly.
- ``igemm.pick_instance`` / ``pick_bn`` over every conv of yolov3-416, and
  the odd cases that must take the element-by-element instance.
- ``conv_int8.direct_plan``, the direct first-conv kernel's tile plan: the
  constants it copies from ``csrc/conv_int8.cu``, 227 KB of shared memory
  at every geometry ``pick_instance`` routes to it, and ``gather`` for a
  stride whose plan would pass that; the markers in the source of
  ``direct_probe``'s and ``tools/int8_ablate``'s altered copies.
- ``decode.plan_tiles`` over the heads the port serves and odd ones: tile
  counts, first-tile indices, 16-byte alignment of every tile, the shared-
  memory budget; the limits the wrapper copies from ``csrc/decode.cu``.
- ``nms.greedy_select``: the shared-memory limit on K it copies from
  ``csrc/nms.cu`` and raises past, the devices and operands it refuses, and
  its plain version on a CPU input.
- ``build.library_path()`` changes when a ``.cuh`` header changes, and each
  ctypes signature has as many arguments as its ``extern "C"`` definition.
"""

import re
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from yolo_tensorflow_tpu.ops import quant as JQ
from yolo_tensorflow_tpu_torch.models import engine as TE
from yolo_tensorflow_tpu_torch.models import specs as TS
from yolo_tensorflow_tpu_torch.ops.kernels import build
from yolo_tensorflow_tpu_torch.ops.kernels import conv_bnstat as BS
from yolo_tensorflow_tpu_torch.ops.kernels import conv_int8 as K
from yolo_tensorflow_tpu_torch.ops.kernels import decode as DK
from yolo_tensorflow_tpu_torch.ops.kernels import direct_probe as DP
from yolo_tensorflow_tpu_torch.ops.kernels import igemm
from yolo_tensorflow_tpu_torch.ops.kernels import nms as NK
from yolo_tensorflow_tpu_torch.ops.kernels import nms_probe as NP
from yolo_tensorflow_tpu_torch.tools import int8_ablate as IA

from torch_parity import model

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _yolov3_convs():
    """Distinct (k, Cin, Cout) of every conv of yolov3-416, in layer order."""
    cfg, specs = model("yolov3", 416)
    shapes = TE.infer_shapes(specs, (1, 416, 416, 3))
    out = []
    for i, spec in enumerate(specs):
        if isinstance(spec, TS.Conv):
            cin = shapes[i - 1][3] if i else 3
            if (spec.size, cin, spec.filters) not in out:
                out.append((spec.size, cin, spec.filters))
    return out


YOLOV3_CONVS = _yolov3_convs()


def _jax_quantized_input(x, s_x, monkeypatch):
    """The int8 tensor quant.conv2d_int8 convolves, for NHWC input x."""
    seen = []
    real = lax.conv_general_dilated

    def capture(xq, *args, **kwargs):
        seen.append(np.asarray(xq))
        return real(xq, *args, **kwargs)

    monkeypatch.setattr(lax, "conv_general_dilated", capture)
    cin = x.shape[-1]
    JQ.conv2d_int8(x, jnp.ones((1, 1, cin, 1), jnp.int8), np.float32(s_x),
                   jnp.ones((1,), jnp.float32), jnp.zeros((1,), jnp.float32),
                   epilogue_dtype=jnp.float32)
    assert len(seen) == 1 and seen[0].dtype == np.int8
    return seen[0]


@pytest.mark.parametrize("s_x", [0.03125, 4.0 / 127])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_plain_matches_jax(dtype, s_x, rng, monkeypatch):
    tdt, jdt = DTYPES[dtype]
    x = rng.normal(0, 40 * s_x, (2, 5, 6, 8)).astype(np.float32)
    flat = x.reshape(-1)
    # exact halves (s_x = 2**-5 divides exactly), both parities, both signs
    flat[:16] = (np.arange(-8, 8) + 0.5) * s_x
    # the clamp: just inside, on, and far past +-127
    flat[16:24] = np.array([126.5, 127.0, 127.5, 128.5, 200.0, 1e4, 3e38,
                            126.49]) * s_x
    flat[24:32] = -flat[16:24]
    flat[32] = 0.0
    flat[33] = -0.0
    x = np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))   # representable
    want = _jax_quantized_input(jnp.asarray(x, jdt), s_x, monkeypatch)
    got = K.quantize_act_plain(
        torch.from_numpy(x.copy()).to(tdt).permute(0, 3, 1, 2), s_x)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    assert want.min() == -127 and want.max() == 127


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (3, 2)])
def test_conv2d_int8_plain_is_quantize_accumulate_epilogue(k, stride, dtype,
                                                           rng):
    tdt, _ = DTYPES[dtype]
    cin, cout, s_x = 16, 24, 4.0 / 127
    x = torch.from_numpy(rng.normal(0, 2, (2, cin, 7, 7)).astype(np.float32))
    x = x.to(tdt).contiguous(memory_format=torch.channels_last)
    w_q = torch.from_numpy(rng.integers(-127, 128, (cout, cin, k, k))
                           .astype(np.int8))
    s_w = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 1, cout).astype(np.float32))
    got = K.conv2d_int8_plain(x, w_q, s_x, s_w, b, stride=stride,
                              epilogue_dtype=tdt)
    xq = K.quantize_act_plain(x, s_x)
    # the quantize the plain version had inline before the split
    old = torch.clamp(torch.round(
        x.float() / torch.tensor(s_x, dtype=torch.float32)), -127, 127)
    assert torch.equal(xq.float(), old)
    acc = K.int8_accumulate(xq, w_q, stride=stride, pad=k // 2)
    assert torch.equal(acc, K.int8_accumulate(old, w_q, stride=stride,
                                              pad=k // 2))
    sc = torch.tensor(s_x, dtype=torch.float32) * s_w
    if tdt == torch.float32:
        want = K.fma_f32(acc.float(), sc.view(1, -1, 1, 1),
                         b.view(1, -1, 1, 1))
    else:
        want = (acc.float().to(tdt) * sc.to(tdt).view(1, -1, 1, 1)
                + b.to(tdt).view(1, -1, 1, 1))
    assert torch.equal(got, want)


def test_quantize_act_on_cpu_is_the_plain_version(rng):
    x = torch.from_numpy(rng.normal(0, 2, (2, 8, 5, 5)).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last)
    before = K.launches
    q = K.quantize_act(x, 0.05)
    assert torch.equal(q, K.quantize_act_plain(x, 0.05))
    assert q.stride() == x.stride() and K.launches == before
    with pytest.raises(TypeError):
        K.quantize_act(x.to(torch.int32), 0.05)


@pytest.mark.parametrize("cout,elem_bytes,bn", [
    (1, 1, 32), (32, 1, 32), (33, 1, 64), (64, 2, 64), (65, 1, 128),
    (128, 2, 128), (255, 1, 128), (255, 2, 128), (1024, 1, 128),
    (256, 1, 128), (256, 2, 256), (1024, 2, 256)])
def test_pick_bn(cout, elem_bytes, bn):
    """The narrowest tile that covers Cout up to 128; from Cout = 256 on
    bf16 takes the 256-wide tile and int8 stays at 128."""
    assert igemm.pick_bn(cout, elem_bytes) == bn
    assert bn in igemm.BN_TILES


@pytest.mark.parametrize("k,cin,cout", YOLOV3_CONVS)
def test_every_yolov3_conv_takes_the_fast_instances(k, cin, cout):
    """Aligned operands: the first conv (Cin = 3) the direct kernel, every
    other conv the cp.async-fed wgmma ring, for int8 (1 byte) and bf16 (2);
    the tile is the narrowest that covers Cout."""
    want = "direct" if cin == 3 else "wgmma"
    for elem_bytes in (1, 2):
        assert igemm.pick_instance(cin, cout, k, elem_bytes, True) == want
    for elem_bytes in (1, 2):
        bn = igemm.pick_bn(cout, elem_bytes)
        assert bn >= min(cout, 128) and (bn == 32 or bn // 2 < cout)
        assert (bn == 256) == (elem_bytes == 2 and cout >= 256)
    # unaligned operands never reach cp.async
    assert igemm.pick_instance(cin, cout, k, 1, False) in ("direct",
                                                           "gather")


def test_yolov3_conv_list_is_the_models():
    assert (3, 3, 32) in YOLOV3_CONVS and (3, 512, 1024) in YOLOV3_CONVS
    assert (1, 1024, 512) in YOLOV3_CONVS and (1, 1024, 255) in YOLOV3_CONVS


@pytest.mark.parametrize("cin,cout,k,elem_bytes,aligned,want", [
    (16, 32, 3, 1, True, "wgmma"),      # 16 int8 = one chunk
    (24, 36, 3, 1, True, "gather"),     # 24 int8: chunks would span taps
    (8, 32, 3, 2, True, "wgmma"),       # 8 bf16 = one chunk
    (12, 36, 3, 2, True, "gather"),     # 12 bf16 = 24 bytes
    (32, 64, 3, 2, False, "gather"),    # an unaligned view
    (3, 32, 3, 2, False, "direct"),     # the direct kernel loads by element
    (3, 16, 3, 1, True, "direct"),
    (3, 20, 3, 1, True, "gather"),      # Cout rows not whole 16-byte stores
    (3, 64, 3, 1, True, "gather"),      # more channels than a thread holds
    (3, 32, 1, 1, True, "gather"),      # 1x1 on 3 channels
])
def test_pick_instance_odd_cases(cin, cout, k, elem_bytes, aligned, want):
    assert igemm.pick_instance(cin, cout, k, elem_bytes, aligned) == want
    assert want in igemm.INSTANCES


def test_wrappers_plan_from_their_operands():
    def cl(*shape, dtype):
        return torch.zeros(shape, dtype=dtype).contiguous(
            memory_format=torch.channels_last)

    x = cl(1, 64, 4, 4, dtype=torch.bfloat16)
    assert BS.plan(x, cl(128, 64, 3, 3, dtype=torch.bfloat16)) == ("wgmma",
                                                                   128)
    assert BS.plan(x, cl(512, 64, 3, 3, dtype=torch.bfloat16)) == ("wgmma",
                                                                   256)
    assert BS.plan(x[:, :3].contiguous(memory_format=torch.channels_last),
                   cl(32, 3, 3, 3, dtype=torch.bfloat16)) == ("direct", 32)
    assert BS.plan(x.float(), cl(48, 64, 3, 3, dtype=torch.float32)) == (
        "ffma", BS.F32_BN)
    assert BS.plan(cl(1, 6, 4, 4, dtype=torch.float32),
                   cl(48, 6, 3, 3, dtype=torch.float32))[0] == "ffma_gather"
    assert K.plan(x, cl(40, 64, 1, 1, dtype=torch.int8)) == ("wgmma", 64)
    assert K.plan(x, cl(255, 24, 3, 3, dtype=torch.int8)) == ("gather", 128)
    # weights one byte past a 16-byte boundary
    flat = torch.zeros(64 * 64 * 9 + 16, dtype=torch.int8)
    off = (1 - flat.data_ptr()) % 16
    w = flat[off:off + 64 * 64 * 9].view(64, 3, 3, 64).permute(0, 3, 1, 2)
    assert w.data_ptr() % 16 != 0
    assert K.plan(x, w) == ("gather", 64)


def test_library_path_follows_the_headers(tmp_path, monkeypatch):
    assert [h.name for h in build.headers()] == ["igemm_sm90.cuh"]
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    before = build.library_path()
    assert before == build.library_path()
    header = csrc / "igemm_sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = build.library_path()
    assert after != before and after.parent == before.parent
    (csrc / "conv_int8.cu").write_text("// edited\n")
    assert build.library_path() not in (before, after)


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_ctypes_signature_matches_the_c_definition(name):
    """As many ctypes arguments as the extern "C" definition has
    parameters, pointers as void pointers, and an int result."""
    text = "".join(src.read_text() for src in build.sources())
    found = re.findall(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert len(found) == 1
    params = [p.strip() for p in found[0].split(",")]
    argtypes, restype = build.SIGNATURES[name]
    assert len(params) == len(argtypes) and restype is build.INT
    for param, ctype in zip(params, argtypes):
        if "*" in param:
            assert ctype in (build.VP, build.ctypes.POINTER(build.F32))
        elif param.startswith("float"):
            assert ctype is build.F32
        elif param.startswith("long long"):
            assert ctype is build.ctypes.c_longlong
        else:
            assert param.startswith("int ") and ctype is build.INT


# ------------------------------------------- the direct first-conv kernel

def _cu_const(name, source="conv_int8.cu"):
    text = (build.CSRC_DIR / source).read_text()
    expr = re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)
    return eval(expr, {"__builtins__": {}})


def test_direct_limits_match_the_source():
    """The wrapper's copies of the direct kernel's tile plan in
    csrc/conv_int8.cu, and the Cout tiles of its instances."""
    assert K.DIRECT_TH == _cu_const("kDirectTH")
    assert K.DIRECT_TW == _cu_const("kDirectTW")
    assert K.DIRECT_TAPS_PER_STEP == _cu_const("kTapsPerStep")
    assert K.DIRECT_W_BANK == _cu_const("kDirectWBank")
    assert K.DIRECT_Y_PAD == _cu_const("kDirectYPad")
    assert K.MAX_SHARED_BYTES == _cu_const("kMaxSharedBytes")
    assert igemm.DIRECT_MAX_COUT == {3: _cu_const("kDirectN3"),
                                     7: _cu_const("kDirectN7")}
    # one warp a row of the tile, in whole m16 tiles
    assert K.DIRECT_TW % 16 == 0 and 32 * K.DIRECT_TH <= 1024


@pytest.mark.parametrize("out_bytes", [4, 2, 1])
@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("k", [3, 7])
def test_direct_plan_fits(k, stride, out_bytes):
    """Every first conv that pick_instance routes to the direct kernel
    (k 3 and 7, stride 1-3, padding 0..k-1, Cout from 8 to the instance's
    most in whole 16-byte chunks of the output; f32, bf16 or int8 out):
    the halo patch covers the tile's taps, K fills whole k32 steps, the grid covers the output, and a CTA's shared memory
    stays within 227 KB."""
    chunk = 16 if out_bytes == 1 else 8
    most = igemm.DIRECT_MAX_COUT[k]
    h, w = 45, 70
    for pad in range(k):
        for cout in range(chunk, most + 1, chunk):
            assert igemm.pick_instance(3, cout, k, 1, True,
                                       out_chunk=chunk) == "direct"
            bn = igemm.pick_bn(cout, 1)
            plan = K.direct_plan(h, w, k, stride, pad, bn, out_bytes)
            assert cout <= plan.n_tile == bn <= most
            assert plan.patch_h == (plan.th - 1) * stride + k
            assert plan.patch_w == (plan.tw - 1) * stride + k
            # K: (ky, kx, c) bytes at k = 3, taps of (c, 0) words at 7
            assert plan.k_bytes == k * k * (3 if k == 3 else 4)
            assert (plan.k_steps - 1) * 32 < plan.k_bytes <= plan.k_steps * 32
            ho = (h + 2 * pad - k) // stride + 1
            wo = (w + 2 * pad - k) // stride + 1
            assert (plan.tiles_h - 1) * plan.th < ho <= plan.tiles_h * plan.th
            assert (plan.tiles_w - 1) * plan.tw < wo <= plan.tiles_w * plan.tw
            assert plan.shared_bytes <= K.MAX_SHARED_BYTES == 227 * 1024
            assert plan.shared_bytes % 16 == 0


# every altered copy of csrc/conv_int8.cu: direct_probe's by name, and
# tools/int8_ablate.py's by its mapping of marker to text
PROBE_COPIES = {**DP.ABLATIONS,
                **{f"int8_ablate:{k}": v for k, v in IA.COPIES.items()}}


@pytest.mark.parametrize("ablation", sorted(PROBE_COPIES))
def test_direct_probe_copies_alter_the_source(ablation):
    """Each altered copy that ops/kernels/direct_probe.py and
    tools/int8_ablate.py build finds each of its markers in
    csrc/conv_int8.cu and puts its text in their place; every marker in the
    source belongs to some copy."""
    source = (build.CSRC_DIR / "conv_int8.cu").read_text()
    texts = PROBE_COPIES[ablation]
    text = DP.patched_source(ablation if ablation in DP.ABLATIONS else texts)
    for name, new in texts.items():
        assert DP.marker(name) in source and DP.marker(name) not in text
        assert all(line.strip() in text for line in new.split("\n"))
    used = {name for a in PROBE_COPIES.values() for name in a}
    assert set(re.findall(r"// \[probe:([^\]]+)\]", source)) == used


# a first conv at a stride whose direct plan passes 227 KB of shared
# memory takes gather: (k, stride, entry's output dtype, instance)
FIT_CASES = [(7, 8, torch.float32, "direct"), (7, 9, torch.float32, "gather"),
             (7, 9, torch.bfloat16, "direct"),
             (7, 10, torch.bfloat16, "gather"), (7, 10, torch.int8, "direct"),
             (7, 11, torch.int8, "gather"), (3, 10, torch.float32, "direct"),
             (3, 11, torch.bfloat16, "gather"), (3, 11, torch.int8, "gather")]


@pytest.mark.parametrize("k,stride,out,want", FIT_CASES)
def test_direct_plan_past_the_shared_memory_limit_takes_gather(k, stride,
                                                               out, want):
    cout = igemm.DIRECT_MAX_COUT[k]
    x = torch.zeros((1, 3, 200, 200)).contiguous(
        memory_format=torch.channels_last)
    w = torch.zeros((cout, 3, k, k), dtype=torch.int8).contiguous(
        memory_format=torch.channels_last)
    if out == torch.int8:
        got = K.plan_q(x.to(torch.int8), w, True, stride)
    else:
        got = K.plan(x.to(out), w, stride, out)
        # the int8-in entry's float32 out: the same shared memory as f32
        if out == torch.float32:
            assert K.plan_q(x.to(torch.int8), w, False, stride) == got
    assert got == (want, cout)
    if want == "direct":
        assert K.direct_plan(200, 200, k, stride, k // 2, cout,
                             out.itemsize).shared_bytes <= K.MAX_SHARED_BYTES
    else:
        with pytest.raises(ValueError):
            K.direct_plan(200, 200, k, stride, k // 2, cout, out.itemsize)


@pytest.mark.parametrize("k,stride", [(7, 13), (3, 30)])
def test_direct_plan_raises_past_the_shared_memory_limit(k, stride):
    with pytest.raises(ValueError, match=f"more than the {227 * 1024}"):
        K.direct_plan(448, 448, k, stride, k // 2, 64 if k == 7 else 32, 4)


# ------------------------------------------------------- the decode kernel

def test_decode_limits_match_the_source():
    """The wrapper's copies of csrc/decode.cu's limits."""
    text = (build.CSRC_DIR / "decode.cu").read_text()

    def const(name):
        expr = re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)
        return eval(expr, {"__builtins__": {}})

    assert DK.MAX_SCALES == const("kMaxScales")
    assert DK.MAX_ANCHORS == const("kMaxAnchors")
    assert DK.MAX_TILE_ROWS == const("kMaxThreads")
    assert DK.MAX_STAGES == const("kMaxStages")
    assert DK.MAX_SHARED_BYTES == const("kMaxSharedBytes")
    assert DK.TILE_ROWS <= DK.MAX_TILE_ROWS and DK.STAGES <= DK.MAX_STAGES


# rows per scale: yolov3-416 at batch 64, a region head at batch 8, ragged
# scales (rows not a multiple of any tile), one row, an empty scale
TILE_ROWS_CASES = [(32448, 129792, 519168), (6760,), (507, 2028, 8112),
                   (1,), (0, 45), (130, 1, 129, 127)]


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("classes", [1, 7, 20, 80, 1000])
@pytest.mark.parametrize("rows", TILE_ROWS_CASES)
def test_decode_tile_plan(rows, classes, elem_bytes):
    """Tile count per scale, first-tile indices, the shared-memory budget,
    and that every full tile spans whole 16-byte chunks from its scale's
    base, so that an aligned base makes every tile's copy aligned."""
    row_elems = 5 + classes
    plan = DK.plan_tiles(rows, row_elems, elem_bytes)
    r = plan.tile_rows
    assert r % 8 == 0 and 8 <= r <= DK.MAX_TILE_ROWS
    assert 2 <= plan.stages <= DK.MAX_STAGES
    assert plan.shared_bytes == plan.stages * r * row_elems * elem_bytes
    assert plan.shared_bytes <= DK.MAX_SHARED_BYTES
    tiles = [-(-n // r) for n in rows]
    assert plan.total_tiles == sum(tiles)
    assert plan.first_tile == tuple(sum(tiles[:k]) for k in range(len(rows)))
    assert (r * row_elems * elem_bytes) % 16 == 0        # a tile, a stage
    for n, first, count in zip(rows, plan.first_tile, tiles):
        for local in {0, 1, count // 2, count - 1} & set(range(count)):
            assert (local * r * row_elems * elem_bytes) % 16 == 0
            valid = min(r, n - local * r)
            assert 0 < valid <= r and (valid == r or local == count - 1)
    # every tile index maps back to exactly one scale, as the kernel maps it
    firsts = list(plan.first_tile) + [2 ** 31 - 1] * (4 - len(rows))
    for tile in {0, plan.total_tiles - 1} & set(range(plan.total_tiles)):
        s = sum(tile >= f for f in firsts[1:])
        assert 0 <= tile - plan.first_tile[s] < tiles[s]


def test_decode_tile_plan_follows_the_row_width():
    """COCO rows: three stages of 128 rows in bf16, two in f32 (three would
    leave no room for two CTAs an SM); 1000 classes in f32: fewer rows."""
    assert DK.plan_tiles([1024], 85, 2)[:3] == (128, 3, 3 * 128 * 170)
    assert DK.plan_tiles([1024], 85, 4)[:3] == (128, 2, 2 * 128 * 340)
    assert DK.plan_tiles([1024], 25, 4)[:2] == (128, 3)
    wide = DK.plan_tiles([1024], 1005, 4)
    assert wide.tile_rows < 128 and wide.stages == 2
    with pytest.raises(ValueError, match="no tile plan"):
        DK.plan_tiles([8], 20005, 4)


def test_decode_launch_arguments_follow_the_scales():
    """The host arrays handed to the kernel for the yolov3-416 heads at
    batch 2: six ints a scale (rows, rows an image, G, A, first output row,
    first tile) and the anchors in grid cells."""
    anchors = ((116, 90), (156, 198), (373, 326))
    geometry = ((13, anchors), (26, ((30, 61), (62, 45), (59, 119))),
                (52, ((10, 13), (16, 30), (33, 23))))
    table, wh, plan = DK._launch_args(2, geometry, 416, 80, 2, 10647)
    assert plan.first_tile == (0, 8, 40)
    assert list(table) == [1014, 507, 13, 3, 0, 0,
                           4056, 2028, 26, 3, 507, 8,
                           16224, 8112, 52, 3, 2535, 40]
    np.testing.assert_allclose(list(wh)[:6], [116 / 32, 90 / 32, 156 / 32,
                                              198 / 32, 373 / 32, 326 / 32])
    assert len(wh) == 18
    with pytest.raises(ValueError, match="10647 rows an image"):
        DK._launch_args(2, geometry, 416, 80, 2, 10646)


def test_decode_wrapper_rejects_what_the_kernel_does_not_take():
    """Checked on the host before any launch, so also without a card."""
    out = DK._outputs(torch.zeros(1), 1, 27)
    anchors = [(10, 13), (16, 30), (33, 23)]

    def launch(feat, n_anchors=3):
        return DK._launch([(feat, anchors[:n_anchors], False)], 96, 4, *out)

    with pytest.raises(TypeError, match="float32 or bfloat16"):
        launch(torch.zeros((1, 3, 3, 27), dtype=torch.float16))
    with pytest.raises(ValueError, match="not .1, G, G"):
        launch(torch.zeros((1, 3, 4, 27)))
    with pytest.raises(ValueError, match="contiguous"):
        launch(torch.zeros((1, 27, 3, 3)).permute(0, 2, 3, 1))
    with pytest.raises(ValueError, match="anchors for 3"):
        launch(torch.zeros((1, 3, 3, 27)), n_anchors=2)
    with pytest.raises(ValueError, match="scales in one"):
        DK._launch([], 96, 4, *out)


# ---------------------------------------------------------- the NMS kernel

def test_nms_limits_match_the_source():
    """The wrapper's copies of csrc/nms.cu's limits."""
    text = (build.CSRC_DIR / "nms.cu").read_text()

    def const(name):
        expr = re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)
        names = set(re.findall(r"\bk[A-Z]\w*", expr))
        return eval(expr, {"__builtins__": {}},
                    {n: const(n) for n in names})

    assert NK.THREADS == const("kThreads")
    assert NK.MAX_SHARED_BYTES == const("kMaxSharedBytes")
    assert NK.BINS == const("kBins")
    assert NK.BYTES_PER_CANDIDATE == const("kBytesPerCandidate")
    assert NK.BYTES_PER_SCORE == const("kBytesPerScore")
    assert NK.FIXED_BYTES == const("kFixedBytes")


@pytest.mark.parametrize("n,k,d,staged", [
    (10647, 256, 20, True),      # yolov3-416
    (22743, 256, 20, True),      # yolov3-608
    (845, 256, 20, True),        # yolov2-416
    (98, 256, 20, True),         # yolov1-448: K = N
    (9000, 9000, 20, False),     # K past the staged layout: scratch
    (256, 256, 20, True), (1024, 1024, 100, True), (60000, 256, 20, False)])
def test_nms_shared_memory_fits(n, k, d, staged):
    """Staged: the keys and the K candidates in shared memory; else the
    kept list alone, the candidates in scratch."""
    kk = min(n, k)
    small = 4 * d + 256 * 16 * 4 + 2 * 16 * 4 + 32
    plan = NK.plan(n, k, d)
    assert plan.candidates == kk and plan.staged == staged
    if staged:
        assert plan.shared_bytes == small + 36 * kk + 4 * n
        assert plan.scratch_bytes == 0
    else:
        assert small + 36 * kk + 4 * n > NK.MAX_SHARED_BYTES
        assert plan.shared_bytes == small and plan.scratch_bytes == 36 * kk
    assert plan.shared_bytes <= NK.MAX_SHARED_BYTES


@pytest.mark.parametrize("n,k,d", [(98, 256, 57000), (9000, 9000, 57000),
                                   (10 ** 7, 2 * 10 ** 6, 10 ** 6)])
def test_nms_raises_past_the_shared_memory_limit(n, k, d):
    with pytest.raises(ValueError, match=f"more than the {227 * 1024}"):
        NK.plan(n, k, d)


def test_nms_probe_stamps_every_phase():
    """nms_probe's copy of csrc/nms.cu reads the clock at each of the
    source's seven phase boundaries, and only there."""
    text = (build.CSRC_DIR / "nms.cu").read_text()
    assert [int(k) for k in re.findall(r"// \[stamp:(\d)\]", text)] == list(
        range(len(NP.PHASES) + 1))
    copy = NP.stamped_source()
    assert "[stamp:" not in copy and copy.count("clock64()") == 7
    assert copy.count("nms_stamps[blockIdx.x * 8 + ") == 7


def _nms_decode(device="cpu", b=2, n=8):
    return (torch.zeros((b, n, 4), device=device),
            torch.zeros((b, n), device=device),
            torch.zeros((b, n), dtype=torch.int32, device=device))


NMS_KW = dict(conf_threshold=0.5, iou_threshold=0.5, max_detections=4,
              num_candidates=6, class_aware=False)


def test_nms_wrapper_raises_on_other_devices():
    with pytest.raises(ValueError, match="runs on cpu or cuda, not meta"):
        NK.greedy_nms(*_nms_decode("meta"), **NMS_KW)


def test_nms_wrapper_rejects_what_the_kernel_does_not_take():
    """Checked on the host before any launch, so also without a card."""
    boxes, scores, labels = _nms_decode()
    with pytest.raises(ValueError, match="int32 labels"):
        NK.greedy_nms(boxes, scores, labels.long(), **NMS_KW)
    with pytest.raises(ValueError, match="f32 boxes"):
        NK.greedy_nms(boxes.double(), scores, labels, **NMS_KW)
    with pytest.raises(ValueError, match=r"boxes \(B, N, 4\)"):
        NK.greedy_nms(boxes[:, :4], scores, labels, **NMS_KW)
    with pytest.raises(ValueError, match=r"scores must be \(B, N\)"):
        NK.greedy_nms(boxes, scores[0], labels, **NMS_KW)
    with pytest.raises(ValueError, match="at least 1"):
        NK.greedy_nms(boxes, scores, labels,
                      **dict(NMS_KW, max_detections=0))
    with pytest.raises(ValueError, match="at least 1"):
        NK.greedy_nms(boxes, scores, labels,
                      **dict(NMS_KW, num_candidates=0))
    with pytest.raises(ValueError, match="below -1"):
        NK.greedy_nms(boxes, scores, labels,
                      **dict(NMS_KW, conf_threshold=-2.0))


def test_nms_wrapper_on_cpu_is_the_plain_version(rng):
    """Unranked decode rows in, the plain version (select_candidates, then
    greedy_select_plain) out, and no launch."""
    boxes = torch.from_numpy(rng.uniform(0, 1, (3, 16, 4)).astype(
        np.float32)).sort(dim=-1).values
    scores = torch.from_numpy(rng.uniform(0, 1, (3, 16)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 3, (3, 16)).astype(np.int32))
    before = NK.launches
    got = NK.greedy_nms(boxes, scores, labels, **NMS_KW)
    want = NK.nms_plain(boxes, scores, labels, **NMS_KW)
    cand = NK.select_candidates(boxes, scores, labels, conf_threshold=0.5,
                                num_candidates=6)
    ranked = NK.greedy_select_plain(
        *cand, **{k: v for k, v in NMS_KW.items() if k != "num_candidates"})
    assert NK.launches == before
    for g, w, r in zip(got, want, ranked):
        assert torch.equal(g, w) and torch.equal(g, r)
