"""Pixel drawing in numpy: the few OpenCV rasters the debug overlays and the
visualizer's images use, pixel for pixel (the card's machine has no
OpenCV).

  * `CIRCLE_R3`: `cv2.circle(img, c, 3, color, 1)` (8-connected, no
    fill) as offsets from the centre;
  * `TILTED_CROSS_5`: `cv2.drawMarker(img, c, color,
    MARKER_TILTED_CROSS, 5, 1)`, two 45-degree lines from c - 2 to c + 2;
  * `draw_line`: `cv2.line(img, p1, p2, color, 1)` with integer end
    points (LINE_8): OpenCV's `clipLine` to the image, then its
    8-connected Bresenham walk from the left end point;
  * `draw_polyline`: `cv2.polylines(img, [pts], closed, color, 1)`, one
    `draw_line` per edge.

Stencils clip pixel by pixel, as OpenCV's circle does;
tests/test_torch_debug_images.py and test_torch_visualizer.py hold all
of them against OpenCV.
"""

from __future__ import annotations

import numpy as np

#: (dx, dy) of the pixels `cv2.circle` sets for radius 3, thickness 1
CIRCLE_R3 = np.array([(-3, 0), (-2, -2), (-2, -1), (-2, 1), (-2, 2), (-1, -2), (-1, 2), (0, -3),
                      (0, 3), (1, -2), (1, 2), (2, -2), (2, -1), (2, 1), (2, 2), (3, 0)], np.int64)

#: (dx, dy) of the pixels `cv2.drawMarker` sets for a 5 px tilted cross
TILTED_CROSS_5 = np.array([(-2, -2), (-2, 2), (-1, -1), (-1, 1), (0, 0), (1, -1), (1, 1), (2, -2),
                           (2, 2)], np.int64)


def stamp(img: np.ndarray, center, offsets: np.ndarray, color) -> None:
    """Set the pixels `center + offsets` that lie inside `img` to `color`."""
    H, W = img.shape[:2]
    x = offsets[:, 0] + int(center[0])
    y = offsets[:, 1] + int(center[1])
    keep = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    img[y[keep], x[keep]] = color


def _clip_line(W: int, H: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's `clipLine` (Cohen-Sutherland on the image rectangle, each
    crossing truncated toward zero). Returns (inside, x1, y1, x2, y2)."""
    right, bottom = W - 1, H - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def line_pixels(W: int, H: int, p1, p2) -> tuple[np.ndarray, np.ndarray]:
    """(x, y) of the pixels `cv2.line` sets in a W x H image between the
    integer points p1 and p2 (thickness 1, LINE_8)."""
    x1, y1, x2, y2 = int(p1[0]), int(p1[1]), int(p2[0]), int(p2[1])
    if not (0 <= x1 < W and 0 <= x2 < W and 0 <= y1 < H and 0 <= y2 < H):
        inside, x1, y1, x2, y2 = _clip_line(W, H, x1, y1, x2, y2)
        if not inside:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # walk from the left end point
        dx, dy, x1, y1 = -dx, -dy, x2, y2
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    major, minor = (dy, dx) if steep else (dx, dy)
    # OpenCV's LineIterator (connectivity 8): the major axis advances every
    # step, the minor one where the error term is negative.
    adv = np.zeros(major + 1, np.int64)
    err = major - 2 * minor
    for k in range(major):
        adv[k + 1] = adv[k] + (err < 0)
        err += 2 * major - 2 * minor if err < 0 else -2 * minor
    steps = np.arange(major + 1, dtype=np.int64)
    if steep:
        return x1 + adv, y1 + sy * steps
    return x1 + steps, y1 + sy * adv


def draw_line(img: np.ndarray, p1, p2, color) -> None:
    """`cv2.line(img, p1, p2, color, 1)` for integer end points."""
    x, y = line_pixels(img.shape[1], img.shape[0], p1, p2)
    img[y, x] = color


def draw_polyline(img: np.ndarray, pts, closed: bool, color) -> None:
    """`cv2.polylines(img, [pts], closed, color, 1)` for (n, 2) integer
    points."""
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    n = len(pts)
    for k in range(n if closed else n - 1):
        draw_line(img, pts[k], pts[(k + 1) % n], color)
