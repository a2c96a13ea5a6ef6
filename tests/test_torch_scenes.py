"""The port's synthetic-shapes generator (yolo_tensorflow_tpu_torch/tools/)
against tools/synthetic_train_demo.py, which draws with cv2.

``tools.raster`` reproduces cv2's 8-connected rasterization, so the port's
scenes are held pixel for pixel: every primitive over 200 random instances
at the task's own size ranges (160 and 416) paints exactly cv2's pixels
(share of the pixels either side paints that both paint: 1.0 reached, 0.98
required; no pixel differs, so none lies more than 1 px from cv2's edge),
and every scene is equal (1.0 reached, 0.99 required). Boxes, labels,
shapes, dtypes and the background draw are equal exactly. The classifier
crops of transfer_pretrain (cv2's uint8 INTER_LINEAR resize there, the
float32 ``dream.resize_linear`` rounded here) sit at most one level apart.
Also the geometry gates of tests/test_synthetic_task.py, on the port's
generator.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from tools import synthetic_train_demo as J  # noqa: E402
from yolo_tensorflow_tpu_torch.tools import raster as R  # noqa: E402
from yolo_tensorflow_tpu_torch.tools import synthetic_train_demo as P  # noqa: E402

WHITE = (255, 255, 255)


@pytest.mark.parametrize("hard", [False, True], ids=["easy", "hard"])
@pytest.mark.parametrize("size", [160, 416])
@pytest.mark.parametrize("seed", [0, 1])
def test_scenes_equal_the_tools(hard, size, seed):
    rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
    equal = []
    for _ in range(32):
        img_j, b_j = J.make_scene(rj, hard=hard, size=size)
        img_p, b_p = P.make_scene(rp, hard=hard, size=size)
        assert img_p.shape == img_j.shape == (size, size, 3)
        assert img_p.dtype == img_j.dtype == np.uint8
        assert b_p.dtype == b_j.dtype == np.float32
        np.testing.assert_array_equal(b_p, b_j)       # boxes and labels
        # the same draws in the same order: background, clutter, shapes
        assert rp.bit_generator.state == rj.bit_generator.state
        equal.append((img_p == img_j).all(-1).mean())
    assert min(equal) >= 0.99, min(equal)             # 1.0 reached
    # make_batch: the same images and padded truths
    ij, tj = J.make_batch(np.random.default_rng(seed + 5), 3, hard=hard,
                          size=size)
    ip, tp = P.make_batch(np.random.default_rng(seed + 5), 3, hard=hard,
                          size=size)
    np.testing.assert_array_equal(tp, tj)
    assert (ip == ij).all(-1).mean() >= 0.99


def test_background_draw_equal():
    """With no shape drawn the scene is the background draw itself."""
    for size in (160, 416):
        rng = np.random.default_rng(9)
        bg = np.random.default_rng(9).integers(0, 60, (size, size, 3),
                                               dtype=np.uint8)
        img, _ = P.make_scene(rng, size=size)
        unpainted = (img < 60).all(-1)
        np.testing.assert_array_equal(img[unpainted], bg[unpainted])


def _shape_geometry(r, size, hard=True):
    sc = size / P.SIZE
    lo, hi = (16, 56) if hard else (24, 64)
    lo, hi = max(6, int(lo * sc)), int(hi * sc)
    s = int(r.integers(lo, hi))
    cx = int(r.integers(s // 2 + 2, size - s // 2 - 2))
    cy = int(r.integers(s // 2 + 2, size - s // 2 - 2))
    return s, cx, cy


def _pts2(r, size):
    return tuple(int(v) for v in r.integers(0, size, 2))


def _draw_line(lib, img, r, size):
    lib.line(img, _pts2(r, size), _pts2(r, size), WHITE,
             max(1, int(r.integers(1, 3) * size / P.SIZE)))


def _draw_speck(lib, img, r, size):
    lib.circle(img, _pts2(r, size), max(1, int(r.integers(1, 3) * size
                                               / P.SIZE)), WHITE, -1)


def _draw_circle(lib, img, r, size):
    s, cx, cy = _shape_geometry(r, size)
    lib.circle(img, (cx, cy), s // 2, WHITE, -1)


def _draw_ring(lib, img, r, size):
    s, cx, cy = _shape_geometry(r, size)
    lib.circle(img, (cx, cy), s // 2, WHITE, max(2, s // 5))


def _draw_rect(lib, img, r, size):
    s, cx, cy = _shape_geometry(r, size)
    w2 = max(3, int(s // 2 * r.uniform(0.45, 1.0)))
    lib.rectangle(img, (cx - w2, cy - s // 2), (cx + w2, cy + s // 2), WHITE,
                  -1)


def _fill(lib):
    return lib.fill_poly if lib is R else lib.fillPoly


def _draw_convex(lib, img, r, size):
    s, cx, cy = _shape_geometry(r, size)
    h = s // 2
    kind = int(r.integers(0, 4))
    if kind == 0:
        pts = np.asarray([(cx, cy - h), (cx - h, cy + h), (cx + h, cy + h)],
                         np.int32)
    elif kind == 1:
        pts = np.asarray([(cx, cy - h), (cx + h, cy), (cx, cy + h),
                          (cx - h, cy)], np.int32)
    else:
        pts = P._poly(cx, cy, h, 5 if kind == 2 else 6,
                      -np.pi / 2 if kind == 2 else 0)
    _fill(lib)(img, [pts], WHITE)


def _draw_star(lib, img, r, size):
    s, cx, cy = _shape_geometry(r, size)
    h = s // 2
    outer = P._poly(cx, cy, h, 5, -np.pi / 2)
    inner = P._poly(cx, cy, max(2, int(h * 0.42)), 5, -np.pi / 2 + np.pi / 5)
    pts = np.empty((10, 2), np.int32)
    pts[0::2], pts[1::2] = outer, inner
    _fill(lib)(img, [pts], WHITE)


def _draw_ellipse(lib, img, r, size):
    s, cx, cy = _shape_geometry(r, size)
    h = s // 2
    ax = (h, max(3, int(h * r.uniform(0.45, 0.65))))
    if r.integers(0, 2):
        ax = ax[::-1]
    lib.ellipse(img, (cx, cy), ax, 0, 0, 360, WHITE, -1)


def _draw_half(lib, img, r, size):
    s, cx, cy = _shape_geometry(r, size)
    h = s // 2
    lib.ellipse(img, (cx, cy), (h, h), int(r.integers(0, 4)) * 90, 0, 180,
                WHITE, -1)


def _near_edge(mask, pts):
    """Whether each (y, x) in ``pts`` lies within 1 px of ``mask``'s edge
    (a pixel whose 3x3 neighbourhood holds both values)."""
    pad = np.pad(mask, 1, mode="edge")
    h, w = mask.shape
    lo, hi = mask.copy(), mask.copy()
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            win = pad[dy:dy + h, dx:dx + w]
            lo &= win
            hi |= win
    edge = hi & ~lo
    pe = np.pad(edge, 1)
    near = np.zeros_like(edge)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            near |= pe[dy:dy + h, dx:dx + w]
    return near[pts[:, 0], pts[:, 1]]


@pytest.mark.parametrize("size", [160, 416])
@pytest.mark.parametrize("draw", [_draw_line, _draw_speck, _draw_circle,
                                  _draw_ring, _draw_rect, _draw_convex,
                                  _draw_star, _draw_ellipse, _draw_half],
                         ids=lambda f: f.__name__[6:])
def test_primitive_matches_cv2(draw, size):
    both = either = 0
    for i in range(200):
        a = np.zeros((size, size, 3), np.uint8)
        b = a.copy()
        draw(cv2, a, np.random.default_rng(i), size)
        draw(R, b, np.random.default_rng(i), size)
        ma, mb = a[..., 0] > 0, b[..., 0] > 0
        both += int((ma & mb).sum())
        either += int((ma | mb).sum())
        diff = np.argwhere(ma != mb)
        if draw is _draw_rect:
            assert len(diff) == 0, (i, diff[:5])
        elif len(diff):
            assert _near_edge(ma, diff).all(), (i, diff[:5])
    assert either > 0
    assert both / either >= 0.98, both / either       # 1.0 reached


def test_transfer_crops_within_one_level():
    """transfer_pretrain's crops: the port's float32 resize, rounded,
    against cv2's uint8 INTER_LINEAR, over one scene's objects at 416 to
    224 and to 64."""
    from yolo_tensorflow_tpu_torch.tools.transfer_pretrain import resize_crop
    rng = np.random.default_rng(21)
    worst, diff_share = 0, []
    for _ in range(2):
        img, boxes = P.make_scene(rng, hard=True, size=416)
        for cx, cy, w, h, _c in boxes:
            s = int(max(w, h) * 416 * 1.6)
            x0 = max(0, min(int(cx * 416 - s / 2), 416 - s))
            y0 = max(0, min(int(cy * 416 - s / 2), 416 - s))
            crop = img[y0:y0 + s, x0:x0 + s]
            for out in (224, 64):
                ref = cv2.resize(crop, (out, out),
                                 interpolation=cv2.INTER_LINEAR)
                d = np.abs(resize_crop(crop, out).astype(int) - ref)
                worst = max(worst, int(d.max()))
                diff_share.append((d > 0).mean())
    assert worst <= 1, worst
    assert max(diff_share) < 0.5, max(diff_share)


# -- the geometry gates of tests/test_synthetic_task.py, on the port ------


def test_easy_scene_unchanged():
    rng = np.random.default_rng(0)
    img, boxes = P.make_scene(rng)
    assert img.shape == (P.SIZE, P.SIZE, 3) and img.dtype == np.uint8
    assert boxes.shape[1] == 5
    assert set(boxes[:, 4].astype(int)) <= set(range(len(P.CLASSES)))


@pytest.mark.parametrize("size", [160, 416])
def test_hard_scene_boxes_valid(size):
    rng = np.random.default_rng(1)
    seen_classes = set()
    for _ in range(300 if size == 160 else 60):
        img, boxes = P.make_scene(rng, hard=True, size=size)
        assert img.shape == (size, size, 3)
        cx, cy, w, h, cls = boxes.T
        seen_classes |= set(cls.astype(int))
        assert (cls >= 0).all() and (cls < len(P.HARD_CLASSES)).all()
        assert (w > 0).all() and (h > 0).all()
        assert (cx - w / 2 >= -1 / size).all()
        assert (cy - h / 2 >= -1 / size).all()
        assert (cx + w / 2 <= 1 + 1 / size).all()
        assert (cy + h / 2 <= 1 + 1 / size).all()
    assert seen_classes == set(range(len(P.HARD_CLASSES)))


@pytest.mark.parametrize("cls_name", ["ellipse", "rect", "semicircle"])
def test_hard_tight_boxes_cover_drawn_pixels(cls_name):
    cls = P.HARD_CLASSES.index(cls_name)
    rng = np.random.default_rng(2)
    for _ in range(50):
        img = np.zeros((P.SIZE, P.SIZE, 3), np.uint8)
        s = int(rng.integers(20, 56))
        cx = int(rng.integers(s // 2 + 2, P.SIZE - s // 2 - 2))
        cy = int(rng.integers(s // 2 + 2, P.SIZE - s // 2 - 2))
        gt = P._draw_shape(img, cls, cx, cy, s, WHITE, rng)
        assert gt is not None
        ys, xs = np.nonzero(img[..., 0])
        px = (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1)
        ix = max(0, min(px[2], gt[2]) - max(px[0], gt[0]))
        iy = max(0, min(px[3], gt[3]) - max(px[1], gt[1]))
        inter = ix * iy
        a = (px[2] - px[0]) * (px[3] - px[1])
        b = (gt[2] - gt[0]) * (gt[3] - gt[1])
        assert inter / (a + b - inter) > 0.8, (cls_name, px, gt)


def test_hard_batch_padding():
    rng = np.random.default_rng(3)
    imgs, tr = P.make_batch(rng, 4, max_boxes=8, hard=True)
    assert imgs.shape == (4, P.SIZE, P.SIZE, 3)
    assert tr.shape == (4, 8, 5)
    for i in range(4):
        nz = np.any(tr[i] != 0, axis=1)
        if not nz.all():
            assert not np.any(tr[i][~nz])
