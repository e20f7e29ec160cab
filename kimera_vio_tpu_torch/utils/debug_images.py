"""Frontend debug imagery: per-keyframe feature-track overlays.

Port of kimera_vio_tpu/utils/debug_images.py (the reference's
logFrontendImg, StereoVisionImuFrontend.cpp:540,599, headless), gated by
the `log_frontend_images` flag: PNGs under
<output_path>/frontend_images with the reference's colour classes (green
= tracked from the previous keyframe, blue = newly detected, red = dead
slot).

Drawn in numpy with OpenCV's stencils (utils/raster.py) and written by
`dataprovider/png.py` as 8-bit RGB: the pixels `cv2.imwrite` stores for
the JAX package's BGR image. Where the JAX function's `cv2.imwrite`
returns False on an I/O error, this one raises.
"""

from __future__ import annotations

import os

import numpy as np

from kimera_vio_tpu_torch.dataprovider.png import write_png
from kimera_vio_tpu_torch.utils import raster

#: RGB colours (the JAX file's BGR tuples reversed)
TRACKED = (0, 200, 0)
NEW = (0, 80, 255)
DEAD = (220, 0, 0)


def feature_track_overlay(img_gray: np.ndarray, uv: np.ndarray, ids: np.ndarray,
                          mask: np.ndarray, prev_ids) -> np.ndarray:
    """The overlay as an (H, W, 3) uint8 RGB array: a radius-3 circle on
    each valid slot with an id (green when the id was valid at the
    previous keyframe, else blue), a 5 px tilted cross on each slot with
    an id that is no longer valid; points outside the image are skipped.
    The gray image is clipped to 0..255 and truncated to uint8."""
    img = np.clip(np.asarray(img_gray), 0, 255).astype(np.uint8)
    vis = np.repeat(img[..., None], 3, axis=2)
    prev = {int(i) for i in prev_ids} if prev_ids is not None else set()
    uv, ids, mask = np.asarray(uv), np.asarray(ids), np.asarray(mask)
    H, W = img.shape[:2]
    for n in range(len(ids)):
        u, v = float(uv[n, 0]), float(uv[n, 1])
        if not (0 <= u < W and 0 <= v < H) or ids[n] < 0:
            continue
        c = (int(round(u)), int(round(v)))
        if mask[n]:
            raster.stamp(vis, c, raster.CIRCLE_R3, TRACKED if int(ids[n]) in prev else NEW)
        else:
            raster.stamp(vis, c, raster.TILTED_CROSS_5, DEAD)
    return vis


def save_feature_track_overlay(
    img_gray: np.ndarray,
    uv: np.ndarray,  # (N,2) rectified pixel coords
    ids: np.ndarray,  # (N,) landmark ids, -1 = free slot
    mask: np.ndarray,  # (N,) slot currently valid
    prev_ids,  # iterable of ids valid at the previous keyframe (or None)
    path: str,
) -> None:
    """Write `feature_track_overlay(...)` as an RGB PNG at `path`."""
    vis = feature_track_overlay(img_gray, uv, ids, mask, prev_ids)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_png(path, vis, filter_type=1)
