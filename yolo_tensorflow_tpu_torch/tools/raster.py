"""OpenCV's 8-connected drawing primitives, in numpy: the pixels that
``cv2.line``, ``cv2.circle``, ``cv2.rectangle``, ``cv2.fillPoly`` and
``cv2.ellipse`` paint at ``LINE_8`` with integer coordinates (shift 0), so
the synthetic-shapes task renders on a host without cv2.

Each function draws in place on an (H, W, 3) uint8 array and follows
OpenCV's own rasterization (modules/imgproc/src/drawing.cpp), not a
look-alike:

- a thin line is the Bresenham walk of ``LineIterator`` from its left end,
  clipped by ``clipLine``;
- a thick line is the 4-vertex polygon at +-thickness/2 in 16-bit fixed
  point (``FillConvexPoly``, its outline by the fixed-point ``Line2``) and
  a round cap at each end (the integer ``Circle`` of radius
  ``(thickness + 1) // 2``);
- a filled circle with thickness -1 is the integer midpoint ``Circle``; an
  outlined one of thickness >= 2 and every ellipse go through
  ``ellipse2Poly``, whose angle step grows as the radius shrinks (90, 30,
  18 or 5 degrees), on OpenCV's 7-decimal sine table; a full ellipse is
  filled as a convex polygon, an arc with the centre added to its polygon;
- ``fill_poly`` is the edge-list scan (``CollectPolyEdges`` +
  ``FillEdgeCollection``) with each edge's outline, so a non-convex star
  fills as cv2 fills it;
- a filled rectangle covers its corners inclusively.

Only what the shapes task draws is here: filled or thick circles, filled
rectangles, polygons and ellipses, and lines of any thickness.
"""

from __future__ import annotations

import functools
import math

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_HALF = XY_ONE >> 1

# OpenCV's SinTable: sin of every whole degree 0..450, to 7 decimals, float32
SIN_TABLE = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(np.float32)


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _cv_round(v: float) -> int:
    """cvRound: round half to even."""
    return int(round(v))


class _Spans:
    """The pixels a primitive paints, gathered as inclusive row spans
    (y, x1, x2) clipped to an h x w image, then painted in one pass: every
    span of one call takes the same colour, so their order is immaterial."""

    def __init__(self, shape):
        self.h, self.w = shape[:2]
        self.rows = []
        self.arrays = []

    def hline(self, y, x1, x2):
        """ICV_HLINE: x1..x2 inclusive on row y, clipped."""
        if 0 <= y < self.h and x2 >= 0 and x1 < self.w:
            self.rows.append((y, max(x1, 0), min(x2, self.w - 1)))

    def point(self, x, y):
        self.hline(y, x, x)

    def hlines(self, ys, x1s, x2s):
        """Many spans at once, as int64 arrays."""
        keep = (ys >= 0) & (ys < self.h) & (x2s >= 0) & (x1s < self.w)
        self.arrays.append(np.stack(
            [ys[keep], np.maximum(x1s[keep], 0),
             np.minimum(x2s[keep], self.w - 1)], 1))

    def paint(self, img, color):
        parts = [np.asarray(self.rows, np.int64).reshape(-1, 3)]
        parts += self.arrays
        s = np.concatenate(parts)
        if not len(s):
            return
        ys, xa, xb = s[:, 0], s[:, 1], s[:, 2]
        y0, x0 = int(ys.min()), int(xa.min())
        hh, ww = int(ys.max()) - y0 + 1, int(xb.max()) - x0 + 2
        base = (ys - y0) * ww - x0
        n = hh * ww
        run = (np.bincount(base + xa, minlength=n)
               - np.bincount(base + xb + 1, minlength=n))
        mask = np.cumsum(run.reshape(hh, ww), axis=1)[:, :-1] > 0
        img[y0:y0 + hh, x0:x0 + ww - 1][mask] = color


def _clip_line(width: int, height: int, p1, p2):
    """clipLine on a width x height box: (ok, p1, p2), ends moved onto the
    border as OpenCV moves them (the double products truncated)."""
    x1, y1 = p1
    x2, y2 = p2
    right, bottom = width - 1, height - 1
    if width <= 0 or height <= 0:
        return False, (x1, y1), (x2, y2)

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line_thin(spans, p1, p2):
    """Line(): LineIterator's 8-connected Bresenham walk, left to right."""
    h, w = spans.h, spans.w
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h
            and 0 <= p2[1] < h):
        ok, p1, p2 = _clip_line(w, h, p1, p2)
        if not ok:
            return
    (x, y), (x2, y2) = p1, p2
    dx, dy = x2 - x, y2 - y
    if dx < 0:                      # leftToRight
        dx, dy = -dx, -dy
        x, y = x2, y2
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    # step along the major axis every pixel, along the minor one when the
    # error goes negative
    if dy > dx:
        dx, dy = dy, dx
        major, minor = (0, sy), (1, 0)
    else:
        major, minor = (sx, 0), (0, sy)
    err = dx - 2 * dy
    for _ in range(dx + 1):
        spans.point(x, y)
        if err < 0:
            err += 2 * dx - 2 * dy
            x += major[0] + minor[0]
            y += major[1] + minor[1]
        else:
            err -= 2 * dy
            x += major[0]
            y += major[1]


def _line_fixed(spans, p1, p2):
    """Line2(): a line between 16-bit fixed-point ends, one pixel a step of
    the major axis."""
    h, w = spans.h, spans.w
    (x1, y1), (x2, y2) = p1, p2
    if not (0 <= x1 < w << XY_SHIFT and 0 <= x2 < w << XY_SHIFT
            and 0 <= y1 < h << XY_SHIFT and 0 <= y2 < h << XY_SHIFT):
        ok, (x1, y1), (x2, y2) = _clip_line(w << XY_SHIFT, h << XY_SHIFT,
                                            p1, p2)
        if not ok:
            return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _trunc_div(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _trunc_div(dx << XY_SHIFT, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += _HALF
    y1 += _HALF
    spans.point((x2 + _HALF) >> XY_SHIFT, (y2 + _HALF) >> XY_SHIFT)
    rows = spans.rows
    if ax > ay:
        x, y = x1 >> XY_SHIFT, y1
        for _ in range(ecount + 1):
            yy = y >> XY_SHIFT
            if 0 <= x < w and 0 <= yy < h:
                rows.append((yy, x, x))
            x += 1
            y += step
    else:
        x, y = x1, y1 >> XY_SHIFT
        for _ in range(ecount + 1):
            xx = x >> XY_SHIFT
            if 0 <= xx < w and 0 <= y < h:
                rows.append((y, xx, xx))
            x += step
            y += 1


@functools.lru_cache(maxsize=None)
def _circle_offsets(radius):
    """Circle()'s midpoint walk for ``radius``: the (dy, dx) pairs of its
    spans, as int64 arrays."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    dys, dxs = [], []
    while dx >= dy:
        dys.append(dy)
        dxs.append(dx)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return np.asarray(dys, np.int64), np.asarray(dxs, np.int64)


def _circle_filled(spans, cx, cy, radius):
    """Circle() with fill: the integer midpoint circle's spans, rows cy +-
    dy from cx - dx to cx + dx and rows cy +- dx from cx - dy to cx + dy."""
    dy, dx = _circle_offsets(radius)
    spans.hlines(np.concatenate([cy - dy, cy + dy, cy - dx, cy + dx]),
                 np.concatenate([cx - dx, cx - dx, cx - dy, cx - dy]),
                 np.concatenate([cx + dx, cx + dx, cx + dy, cx + dy]))


def _fill_convex(spans, v, shift):
    """FillConvexPoly(): two edges walked down from the top vertex, each
    row filled between them; the outline drawn first."""
    h, w = spans.h, spans.w
    npts = len(v)
    delta = (1 << shift) >> 1
    p0 = (v[-1][0] << (XY_SHIFT - shift), v[-1][1] << (XY_SHIFT - shift))
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, (px, py) in enumerate(v):
        if py < ymin:
            ymin, imin = py, i
        ymax = max(ymax, py)
        xmax = max(xmax, px)
        xmin = min(xmin, px)
        p = (px << (XY_SHIFT - shift), py << (XY_SHIFT - shift))
        if shift == 0:
            _line_thin(spans, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT),
                       (p[0] >> XY_SHIFT, p[1] >> XY_SHIFT))
        else:
            _line_fixed(spans, p0, p)
        p0 = p
    xmin = (xmin + delta) >> shift
    xmax = (xmax + delta) >> shift
    ymin = (ymin + delta) >> shift
    ymax = (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per edge: [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges = npts
    y = ymin
    rows = []
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while True:
                    edges -= 1
                    if edges + 1 <= 0:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs = v[idx0][0] << (XY_SHIFT - shift)
                        xe = v[idx][0] << (XY_SHIFT - shift)
                        e[4] = ty
                        e[3] = _trunc_div((xe - xs) * 2 + (ty - y),
                                          2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            rows.append((y, (edge[left][2] + _HALF) >> XY_SHIFT,
                         (edge[right][2] + _HALF) >> XY_SHIFT))
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break
    if rows:
        r = np.asarray(rows, np.int64)
        spans.hlines(r[:, 0], r[:, 1], r[:, 2])


def _collect_edges(spans, v, shift, edges):
    """CollectPolyEdges(): each edge's outline, and its (y0, y1, x, dx) in
    16-bit fixed point for the scan."""
    h, w = spans.h, spans.w
    delta = (1 << shift) >> 1
    last = v[-1]
    pt0 = (last[0] << (XY_SHIFT - shift), (last[1] + delta) >> shift)
    for px, py in v:
        pt1 = (px << (XY_SHIFT - shift), (py + delta) >> shift)
        t0 = ((pt0[0] + _HALF) >> XY_SHIFT, pt0[1])
        t1 = ((pt1[0] + _HALF) >> XY_SHIFT, pt1[1])
        _line_thin(spans, t0, t1)
        c0, c1 = pt0, pt1
        if not (0 <= t0[0] < w and 0 <= t1[0] < w and 0 <= t0[1] < h
                and 0 <= t1[1] < h):
            _, t0, t1 = _clip_line(w, h, t0, t1)
            if t0[1] != t1[1]:
                c0 = (t0[0] << XY_SHIFT, t0[1])
                c1 = (t1[0] << XY_SHIFT, t1[1])
        if pt0[1] != pt1[1]:
            dx = _trunc_div(c1[0] - c0[0], c1[1] - c0[1])
            if pt0[1] < pt1[1]:
                edges.append((pt0[1], pt1[1], c0[0] + (pt0[1] - c0[1]) * dx,
                              dx))
            else:
                edges.append((pt1[1], pt0[1], c1[0] + (pt1[1] - c1[1]) * dx,
                              dx))
        pt0 = pt1


def _fill_edges(spans, edges):
    """FillEdgeCollection(): every row between the edges' ends filled
    between consecutive pairs of the active edges, sorted by x, from the
    first pixel at or right of the left edge to the last pixel at or left
    of the right one (the installed OpenCV's rule, held by the tests)."""
    h, w = spans.h, spans.w
    if len(edges) < 2:
        return
    e = np.asarray(edges, np.int64)
    y0, y1, x0, dx = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
    xend = x0 + (y1 - y0) * dx
    if (y1.max() < 0 or y0.min() >= h or max(x0.max(), xend.max()) < 0
            or min(x0.min(), xend.min()) >= (w << XY_SHIFT)):
        return
    rows, xs = [], []
    for a, b, x, d in zip(y0.tolist(), y1.tolist(), x0.tolist(),
                          dx.tolist()):
        ys = np.arange(a, min(b, h), dtype=np.int64)
        rows.append(ys)
        xs.append(x + (ys - a) * d)
    rows = np.concatenate(rows)
    xs = np.concatenate(xs)
    order = np.lexsort((xs, rows))
    rows, xs = rows[order], xs[order]
    spans.hlines(rows[0::2], (xs[0::2] + XY_ONE - 1) >> XY_SHIFT,
               xs[1::2] >> XY_SHIFT)


def _ellipse_poly(center, axes, angle, arc_start, arc_end, delta):
    """ellipse2Poly() on double-precision (fixed-point) centre and axes."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start += 360
        arc_end += 360
    while arc_end > 360:
        arc_end -= 360
        arc_start -= 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    alpha = float(SIN_TABLE[450 - angle])      # cos
    beta = float(SIN_TABLE[angle])             # sin
    pts = []
    i = arc_start
    while i < arc_end + delta:
        a = min(i, arc_end)
        if a < 0:
            a += 360
        x = axes[0] * float(SIN_TABLE[450 - a])
        y = axes[1] * float(SIN_TABLE[a])
        pts.append((center[0] + x * alpha - y * beta,
                    center[1] + x * beta + y * alpha))
        i += delta
    if len(pts) == 1:
        pts = [center, center]
    return pts


def _ellipse_ex(spans, center, axes, angle, arc_start, arc_end, thickness):
    """EllipseEx(): the arc's polygon in 16-bit fixed point, then a thick
    polyline (thickness >= 0), a convex fill (a full turn) or an edge fill
    with the centre added (an arc)."""
    ax, ay = abs(axes[0]), abs(axes[1])
    r = (max(ax, ay) + _HALF) >> XY_SHIFT
    delta = 90 if r < 3 else 30 if r < 10 else 18 if r < 15 else 5
    v = []
    for px, py in _ellipse_poly((float(center[0]), float(center[1])),
                                (float(ax), float(ay)), angle, arc_start,
                                arc_end, delta):
        qx = _cv_round(px / XY_ONE) << XY_SHIFT
        qy = _cv_round(py / XY_ONE) << XY_SHIFT
        pt = (qx + _cv_round(px - qx), qy + _cv_round(py - qy))
        if not v or pt != v[-1]:
            v.append(pt)
    if len(v) == 1:
        v = [tuple(center), tuple(center)]
    if thickness >= 0:
        _polyline(spans, v, thickness, XY_SHIFT)
    elif arc_end - arc_start >= 360:
        _fill_convex(spans, v, XY_SHIFT)
    else:
        v.append(tuple(center))
        edges = []
        _collect_edges(spans, v, XY_SHIFT, edges)
        _fill_edges(spans, edges)


def _thick_line(spans, p0, p1, thickness, flags, shift):
    """ThickLine(): a thin line, or the fixed-point band and round caps
    (flags bit 1: the first end, bit 2: the second)."""
    s = XY_SHIFT - shift
    p0 = (p0[0] << s, p0[1] << s)
    p1 = (p1[0] << s, p1[1] << s)
    if thickness <= 1:
        _line_thin(spans, ((p0[0] + _HALF) >> XY_SHIFT,
                         (p0[1] + _HALF) >> XY_SHIFT),
                   ((p1[0] + _HALF) >> XY_SHIFT, (p1[1] + _HALF) >> XY_SHIFT))
        return
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > 2.220446049250313e-16:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = _cv_round(dy * r), _cv_round(dx * r)
        _fill_convex(spans, [(p0[0] + dpx, p0[1] + dpy),
                           (p0[0] - dpx, p0[1] - dpy),
                           (p1[0] - dpx, p1[1] - dpy),
                           (p1[0] + dpx, p1[1] + dpy)], XY_SHIFT)
    for i in range(2):
        if flags & (i + 1):
            _circle_filled(spans, (p0[0] + _HALF) >> XY_SHIFT,
                           (p0[1] + _HALF) >> XY_SHIFT,
                           (thickness + _HALF) >> XY_SHIFT)
        p0 = p1


def _polyline(spans, v, thickness, shift):
    """PolyLine(), open: caps at both ends of the first segment, at the far
    end of the others."""
    flags = 3
    p0 = v[0]
    for p in v[1:]:
        _thick_line(spans, p0, p, thickness, flags, shift)
        p0 = p
        flags = 2


def _drawn(img, color, draw, *args):
    """Run ``draw(spans, *args)`` and paint its spans on ``img``."""
    spans = _Spans(img.shape)
    draw(spans, *args)
    spans.paint(img, np.asarray(color, np.uint8))


def line(img, p0, p1, color, thickness=1):
    """cv2.line(img, p0, p1, color, thickness) at LINE_8."""
    _drawn(img, color, _thick_line, tuple(map(int, p0)), tuple(map(int, p1)),
           int(thickness), 3, 0)


def circle(img, center, radius, color, thickness=1):
    """cv2.circle at LINE_8: filled for thickness < 0, outlined at
    thickness >= 2 (the one-pixel outline is not drawn by the task)."""
    cx, cy = int(center[0]), int(center[1])
    radius, thickness = int(radius), int(thickness)
    if thickness < 0:
        _drawn(img, color, _circle_filled, cx, cy, radius)
    elif thickness >= 2:
        _drawn(img, color, _ellipse_ex, (cx << XY_SHIFT, cy << XY_SHIFT),
               (radius << XY_SHIFT, radius << XY_SHIFT), 0, 0, 360, thickness)
    else:
        raise NotImplementedError("circle outlines thinner than 2 pixels")


def rectangle(img, p0, p1, color, thickness=-1):
    """cv2.rectangle filled (thickness < 0): corners inclusive."""
    if thickness >= 0:
        raise NotImplementedError("rectangle outlines")
    h, w = img.shape[:2]
    x0, x1 = sorted((int(p0[0]), int(p1[0])))
    y0, y1 = sorted((int(p0[1]), int(p1[1])))
    if x1 < 0 or y1 < 0 or x0 >= w or y0 >= h:
        return
    img[max(y0, 0):min(y1, h - 1) + 1, max(x0, 0):min(x1, w - 1) + 1] = \
        np.asarray(color, np.uint8)


def _polys(spans, polys):
    edges = []
    for pts in polys:
        _collect_edges(spans, [(int(x), int(y)) for x, y in np.asarray(pts)],
                       0, edges)
    _fill_edges(spans, edges)


def fill_poly(img, polys, color):
    """cv2.fillPoly(img, polys, color) at LINE_8: any polygon, convex or
    not, each given as an (N, 2) integer array."""
    _drawn(img, color, _polys, polys)


def ellipse(img, center, axes, angle, start, end, color, thickness=-1):
    """cv2.ellipse(img, center, axes, angle, start, end, color, thickness)
    at LINE_8 with whole-degree angles."""
    _drawn(img, color, _ellipse_ex,
           (int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT),
           (int(axes[0]) << XY_SHIFT, int(axes[1]) << XY_SHIFT),
           _cv_round(angle), _cv_round(start), _cv_round(end), int(thickness))
