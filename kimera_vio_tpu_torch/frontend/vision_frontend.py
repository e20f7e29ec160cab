"""Vision frontend (stereo, mono, RGB-D): per-frame tracking, per-keyframe
geometry.

Port of kimera_vio_tpu/frontend/vision_frontend.py::StereoFrontend with
the reference's three trackers (`FrontendConfig.lk_impl`) and its state
storage policy:

  * "matmul" (the default, as in the reference): at each keyframe the
    template cache of `optical_flow.build_lk_templates` is built by
    `lk_cache_build_kernel` (`build_lk_templates_lk`) and kept in the
    state (`lkf_templates`; no pyramid, no gradients), and every frame is
    tracked against it by `lk_cached_kernel` (`klt_track_cached_lk`);
  * "gather": the last keyframe's pyramid and Scharr gradients are kept,
    and every frame is tracked by `klt_track_lk(search_rows=None)`, the
    gather rule at every window width;
  * "pallas": the same state, tracked with the Pallas tracker's window
    rule (`klt_track_lk`, search_rows 56) up to 54 px; wider windows take
    the gather rule, since the window rule admits none (ops/lk_kernel.py).

Per frame: preintegrate the IMU block since the last keyframe; predict the
keypoints' motion from the gyro rotation; track lkf -> current with LK;
apply the keyframe policy (VisionImuFrontend::shouldBeKeyframe). The
reference gates the keyframe branch with `lax.cond` on the device; here it
is a host `if` on the decision, which needs the tracked count and the
median disparity on the host (one small copy per frame). The per-frame
part (`track`) also takes B streams stacked, in the same launches:
`FleetVio` (parallel/fleet.py) then decides and runs the keyframe half
per stream (`decide`, `finish`), as `process_frame` does for one.

Per keyframe: mono RANSAC (2-pt given the gyro rotation, or 5-pt),
re-detection (GFTT, Harris, FAST or ORB; binning or ANMS types 0-5),
stereo matching, stereo RANSAC (1-pt
voting given the rotation, or 3-pt Arun), measurements for the backend.
RANSAC hypotheses come from a `torch.Generator` seeded with the frame
count (the reference folds the frame count into PRNGKey(0)).

`mono`: no stereo matching or stereo RANSAC; measurements carry uR = NaN
(MonoVisionImuFrontend). `rgbd`: the right image is a metric depth image;
each keypoint's bilinear depth becomes a virtual-stereo disparity
fx * b / z, gated to (depth_min, depth_max) (RgbdVisionImuFrontend).
Every mode exports the mono and stereo RANSAC poses (`R_mono`, `t_mono`,
`R_stereo`, `t_stereo_vote`) for the pipeline's pose guesses, between
factors, online initialization and time alignment.

With `lcd_features > 0` the keyframe branch also runs the loop-closure
feature front half on the rectified pair (`extract_lcd_features`: GFTT,
ORB, sparse stereo) and returns its `lcd_*` fields on the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kimera_vio_tpu_torch.common.types import (
    ImuBias,
    ImuBlock,
    StereoMeasurements,
    TrackedFeatures,
    replace,
)
from kimera_vio_tpu_torch.frontend import imu_frontend as imu
from kimera_vio_tpu_torch.frontend.camera import (
    DIST_NONE,
    SeparableRemap,
    StereoCamera,
    rectification_map,
    undistort_to_normalized,
)
from kimera_vio_tpu_torch.loopclosure import orb as orb_mod
from kimera_vio_tpu_torch.ops import corner_detection as det
from kimera_vio_tpu_torch.ops import optical_flow as of
from kimera_vio_tpu_torch.ops import ransac
from kimera_vio_tpu_torch.ops.lk_kernel import MAX_WIN as LK_MAX_WIN
from kimera_vio_tpu_torch.ops.lk_kernel import (build_lk_templates_lk, klt_track_cached_lk,
                                                klt_track_lk)
from kimera_vio_tpu_torch.ops.stereo_matching import match_stereo
from kimera_vio_tpu_torch.utils.stats import span

TRACKING_VALID = 0
TRACKING_LOW_DISPARITY = 1
TRACKING_FEW_MATCHES = 2
TRACKING_INVALID = 3
LK_IMPLS = ("matmul", "gather", "pallas")


def _f32(x) -> float:
    """A Python float holding the float32 value of x (the reference keeps
    these thresholds as float32 scalars)."""
    return float(np.float32(x))


@dataclass
class FrontendConfig:
    """Static frontend configuration (host values)."""

    max_features: int = 384
    klt_win: int = 24
    klt_max_iter: int = 30
    klt_max_level: int = 4
    klt_eps: float = 0.1
    templ_cols: int = 101
    templ_rows: int = 11
    max_disparity: int = 128
    n_hyp_mono: int = 128
    nr_horizontal_bins: int = 7
    nr_vertical_bins: int = 5
    # FeatureDetector type: 0 FAST, 1 ORB (FAST-gated, Harris-ranked), 2
    # AGAST (refused, as in the reference), 3 GFTT.
    detector_type: int = 3
    # AnmsAlgorithmType: 6 binning; 0-5 TopN / BrownANMS / SDC / KdTree /
    # RangeTree / SSC over the strongest candidates (ops/anms.py).
    anms_type: int = 6
    max_nr_keypoints_before_anms: int = 1024
    use_harris: bool = False  # GFTT ranks by the Harris response
    harris_k: float = 0.04
    fast_thresh: float = 10.0
    do_subpixel: bool = True
    max_feature_age: int = 25
    quality_level: float = _f32(0.001)
    min_distance: float = 20.0
    min_intra_kf_time: float = _f32(0.2)
    max_intra_kf_time: float = 5.0
    min_features: int = 0
    disparity_threshold: float = 0.5
    max_disparity_since_lkf: float = 1000.0
    ransac_threshold_mono: float = _f32(1e-6)
    ransac_threshold_stereo: float = _f32(6.2514)
    min_mono_inliers: int = 10
    min_stereo_inliers: int = 5
    min_point_dist: float = 0.5
    max_point_dist: float = 10.0
    templ_tolerance: float = _f32(0.15)
    pixel_sigma: float = 1.0
    mono: bool = False
    rgbd: bool = False
    depth_min: float = _f32(0.1)  # RGB-D depth gate (m)
    depth_max: float = 10.0
    use_2point_mono: bool = True  # else 5-pt
    use_1point_stereo: bool = True  # else 3-pt Arun
    # > 0: the keyframe branch extracts this many loop-closure features
    # (LcdParams.nfeatures, spaced by lcd_min_distance) on the device.
    lcd_features: int = 0
    lcd_min_distance: float = 12.0
    # The LK tracker (LK_IMPLS): "matmul", the reference's default, tracks
    # against a per-keyframe template cache; "gather" and "pallas" from the
    # keyframe's pyramid and gradients (see the module docstring).
    lk_impl: str = "matmul"

    @classmethod
    def from_params(cls, fp, max_features=384) -> "FrontendConfig":
        """From a FrontendParams, as the JAX package's `from_params`.
        Without non-max suppression the ANMS type is 0 (TopN); the
        candidate pool is capped at 1024. The JAX package does not read
        use_harris_detector, k and fast_thresh (its detector runs with
        their defaults); the port reads them, as the reference does."""
        return cls(
            max_features=max_features,
            klt_win=fp.klt_win_size,
            klt_max_iter=fp.klt_max_iter,
            klt_max_level=fp.klt_max_level,
            klt_eps=float(fp.klt_eps),
            templ_cols=fp.templ_cols,
            templ_rows=fp.templ_rows,
            nr_horizontal_bins=fp.nr_horizontal_bins,
            nr_vertical_bins=fp.nr_vertical_bins,
            detector_type=int(fp.feature_detector_type),
            anms_type=int(fp.non_max_suppression_type) if fp.enable_non_max_suppression else 0,
            max_nr_keypoints_before_anms=min(int(fp.max_nr_keypoints_before_anms), 1024),
            use_harris=bool(fp.use_harris_detector),
            harris_k=float(fp.k),
            fast_thresh=float(fp.fast_thresh),
            do_subpixel=fp.enable_subpixel_corner_finder,
            max_feature_age=int(fp.max_feature_age),
            quality_level=_f32(fp.quality_level),
            min_distance=_f32(fp.min_distance),
            min_intra_kf_time=_f32(fp.min_intra_keyframe_time_s),
            max_intra_kf_time=_f32(fp.max_intra_keyframe_time_s),
            min_features=int(fp.min_number_features),
            disparity_threshold=_f32(fp.disparity_threshold),
            max_disparity_since_lkf=_f32(fp.max_disparity_since_lkf),
            ransac_threshold_mono=_f32(fp.ransac_threshold_mono),
            ransac_threshold_stereo=_f32(6.2514 * fp.ransac_threshold_stereo),
            min_mono_inliers=int(fp.min_nr_mono_inliers),
            min_stereo_inliers=int(fp.min_nr_stereo_inliers),
            min_point_dist=_f32(fp.min_point_dist),
            max_point_dist=_f32(fp.max_point_dist),
            templ_tolerance=_f32(fp.tolerance_template_matching),
            n_hyp_mono=max(64, min(512, (fp.ransac_max_iterations + 63) // 64 * 64)),
            use_2point_mono=bool(fp.ransac_use_2point_mono),
            use_1point_stereo=bool(fp.ransac_use_1point_stereo),
        )


@dataclass
class FrontendState:
    """Frontend state carried frame to frame. Host scalars are Python
    values; `lkf_stamp` is the float32 value of the keyframe stamp."""

    features: TrackedFeatures  # tracked at the current frame
    lkf_features: TrackedFeatures  # as of the last keyframe
    lkf_pyramid: tuple  # last keyframe's pyramid, level 0 first (empty under matmul)
    lkf_grads: tuple  # its Scharr gradients ((gx, gy) per level; empty under matmul)
    pim: imu.Pim  # accumulated since the last keyframe
    imu_bias: ImuBias
    lkf_uvd: torch.Tensor  # (N,3) last keyframe's stereo measurements
    lkf_uvd_mask: torch.Tensor  # (N,)
    lkf_stamp: float
    next_id: int
    frame_count: int
    kf_count: int
    last_status: int = TRACKING_VALID
    # Under matmul: the last keyframe's LK template cache, one dict a level
    # (None where the level cannot hold a window), level 0 first.
    lkf_templates: tuple = ()


def extract_lcd_features(stereo, left_rect: torch.Tensor, right_rect: torch.Tensor,
                         n_features: int, min_distance: float) -> dict:
    """The LCD's feature front half on the device: GFTT keypoints (no
    sub-pixel step), ORB descriptors, sparse stereo with a 31x11
    template, and the stereo backprojections. Returns the reference's
    `lcd_*` fields (uv, ok, desc, versors, pts3)."""
    dev = left_rect.device
    uv, ok = det.detect_features(
        left_rect, torch.zeros((8, 2), device=dev), torch.zeros(8, dtype=torch.bool, device=dev),
        n_features, min_distance=min_distance, do_subpixel=False)
    desc, _, dok = orb_mod.orb_descriptors(left_rect, uv, ok)
    uvr, _, sok = match_stereo(left_rect, right_rect, uv, ok, fx=stereo.fx,
                               baseline=stereo.baseline, templ_cols=31, templ_rows=11,
                               max_disparity=128)
    pts3 = stereo.backproject_rect(torch.stack([uv[:, 0], uvr[:, 0], uv[:, 1]], -1))
    versors = pts3 / torch.clamp(torch.linalg.norm(pts3, dim=-1, keepdim=True), min=1e-9)
    return {"lcd_uv": uv.to(torch.float32), "lcd_ok": dok & sok, "lcd_desc": desc,
            "lcd_versors": versors.to(torch.float32), "lcd_pts3": pts3.to(torch.float32)}


def _nanmedian_linear(x: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Median of x over `ok` along the last axis, averaging the two middle
    values for an even count (jnp.nanmedian's linear interpolation;
    torch.nanmedian returns the lower one); 0 when nothing is valid."""
    n = ok.sum(-1)
    v, _ = torch.sort(torch.where(ok, x, torch.full_like(x, torch.inf)), dim=-1)
    k = torch.clamp(n - 1, min=0).to(torch.float32) * 0.5
    lo = torch.floor(k)
    hi = torch.ceil(k)
    hw = k - lo

    def at(i):
        return torch.gather(v, -1, i.to(torch.int64)[..., None])[..., 0]

    med = at(lo) * (1.0 - hw) + at(hi) * hw
    return torch.where(n > 0, med, torch.zeros_like(med))


@dataclass
class Tracked:
    """`StereoFrontend.track`'s result, for one stream or B stacked: the
    tracked features, the current pyramid, the PIM since the last keyframe,
    the gyro rotation in the rectified camera, and the policy inputs
    ((..., 2): tracked count, median disparity), on the host after `read`
    (`track_async` leaves them on the device)."""

    features: TrackedFeatures
    pyramid: list
    pim: imu.Pim
    R_cam: torch.Tensor
    policy: np.ndarray | torch.Tensor

    def read(self) -> "Tracked":
        """The policy inputs copied to the host, in one transfer."""
        with span("frontend.track_read"):
            return replace(self, policy=self.policy.cpu().numpy())

class StereoFrontend:
    """Host orchestrator of the per-frame / per-keyframe computations."""

    def __init__(self, cfg: FrontendConfig, stereo: StereoCamera, pim_params: imu.PimParams,
                 device: torch.device):
        if cfg.lk_impl not in LK_IMPLS:
            raise ValueError(f"lk_impl {cfg.lk_impl!r}: one of {LK_IMPLS}")
        self.cfg = cfg
        self.stereo = stereo
        self.pim_params = pim_params
        self.device = device
        self.left = stereo.left
        lf = self.left
        self.identity_rect = bool(
            lf.dist_model == DIST_NONE
            and np.allclose(stereo.R_rect_l.cpu().numpy(), np.eye(3), atol=1e-6)
            and np.allclose(
                [float(stereo.fx), float(stereo.fy), float(stereo.cx), float(stereo.cy)],
                [float(lf.fx), float(lf.fy), float(lf.cx), float(lf.cy)],
            )
        )
        if not self.identity_rect:
            # The keyframe images rectify through the separable remap, as
            # in the JAX frontend; the maps stay for the mesher's dense
            # depth, which the JAX package remaps with the gather.
            maps = (rectification_map(stereo, stereo.left, stereo.R_rect_l),
                    rectification_map(stereo, stereo.right, stereo.R_rect_r))
            self.map_left, self.map_right = (torch.from_numpy(m).to(device) for m in maps)
            self.sep_remap_left, self.sep_remap_right = (SeparableRemap(m, device) for m in maps)
        K_raw = np.array(
            [[float(lf.fx), 0.0, float(lf.cx)], [0.0, float(lf.fy), float(lf.cy)], [0.0, 0.0, 1.0]],
            np.float32,
        )
        self.K_raw = torch.from_numpy(K_raw).to(device)
        self.K_raw_inv = torch.from_numpy(np.linalg.inv(K_raw).astype(np.float32)).to(device)
        self.R_cam_body = stereo.R_b_rect.T.contiguous()
        self.R_leftcam_body = self.left.R_bc.T.contiguous()

    # ------------------------------------------------------------------
    def _remap_left(self, img):
        return img if self.identity_rect else self.sep_remap_left(img)

    def _remap_right(self, img):
        return img if self.identity_rect else self.sep_remap_right(img)

    def _right_rect(self, img):
        """The rectified right image; an RGB-D depth image is used as it
        is, and a mono frontend has none."""
        return img if self.cfg.rgbd or self.cfg.mono else self._remap_right(img)

    def _rect_and_versors(self, uv_raw):
        """(uv_rect, versors) from one shared undistortion; (..., N, 2)
        pixels of one stream or B."""
        xy = undistort_to_normalized(self.left, uv_raw, iters=10)
        rays = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
        rays = (self.stereo.R_rect_l @ rays[..., None])[..., 0]
        versors = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
        if self.identity_rect:
            return uv_raw, versors
        z = torch.clamp(rays[..., 2], min=1e-8)
        u = self.stereo.fx * rays[..., 0] / z + self.stereo.cx
        v = self.stereo.fy * rays[..., 1] / z + self.stereo.cy
        return torch.stack([u, v], dim=-1), versors

    def _detect(self, img, feats: TrackedFeatures):
        cfg = self.cfg
        return det.detect_features(
            img, feats.uv, feats.mask, cfg.max_features,
            detector_type=cfg.detector_type, quality_level=cfg.quality_level,
            min_distance=cfg.min_distance, use_harris=cfg.use_harris, harris_k=cfg.harris_k,
            fast_thresh=cfg.fast_thresh, nr_horizontal_bins=cfg.nr_horizontal_bins,
            nr_vertical_bins=cfg.nr_vertical_bins, do_subpixel=cfg.do_subpixel,
            anms_type=cfg.anms_type,
            max_nr_keypoints_before_anms=cfg.max_nr_keypoints_before_anms,
        )

    def _lk_store(self, pyr, feats: TrackedFeatures) -> dict:
        """What the state keeps of a keyframe for LK (the reference's
        storage policy): under matmul the template cache of its features
        (gradients taken on the patches) and no pyramid; otherwise the
        pyramid and its Scharr gradients."""
        with span("lk.cache_build"):
            if self.cfg.lk_impl == "matmul":
                return {"lkf_pyramid": (), "lkf_grads": (),
                        "lkf_templates": build_lk_templates_lk(list(pyr), feats.uv, feats.mask,
                                                               win=self.cfg.klt_win,
                                                               device=self.device)}
            return {"lkf_pyramid": tuple(pyr), "lkf_grads": tuple(of._grad(p) for p in pyr),
                    "lkf_templates": ()}

    # ------------------------------------------------------------------
    def init_state(self, left_img, right_img, stamp: float):
        """First frame: detect, stereo-match, start the state. Returns
        (state, measurements)."""
        cfg = self.cfg
        dev = self.device
        left_img = left_img.to(torch.float32)
        right_img = right_img.to(torch.float32)
        pyr = of.build_pyramid(left_img, cfg.klt_max_level)
        empty = TrackedFeatures.empty(cfg.max_features, dev)
        uv, valid = self._detect(left_img, empty)
        ar = torch.arange(cfg.max_features, dtype=torch.int32, device=dev)
        ids = torch.where(valid, ar, torch.full_like(ar, -1))
        uv_rect0, versors0 = self._rect_and_versors(uv)
        feats = TrackedFeatures(
            uv=uv, uv_rect=uv_rect0, versors=versors0, ids=ids,
            ages=torch.zeros(cfg.max_features, dtype=torch.int32, device=dev), mask=valid,
        )
        meas = self._stereo_measurements(self._remap_left(left_img), self._right_rect(right_img), feats)
        state = FrontendState(
            features=feats,
            lkf_features=feats,
            **self._lk_store(pyr, feats),
            pim=imu.Pim.zero(device=dev),
            imu_bias=ImuBias.zero(dev),
            lkf_uvd=meas.uvs,
            lkf_uvd_mask=meas.mask,
            lkf_stamp=_f32(stamp),
            next_id=cfg.max_features,
            frame_count=1,
            kf_count=1,
        )
        return state, meas

    def _stereo_measurements(self, left_rect, right_rect, feats) -> StereoMeasurements:
        """Measurements (uL, uR, v) of the current features: by stereo
        matching; in RGB-D mode from the depth image `right_rect` (bilinear
        depth -> uR = uL - fx b / z, RgbdFrame::fillStereoFrame); in mono
        mode with uR = NaN."""
        cfg = self.cfg
        u, v = feats.uv_rect[:, 0], feats.uv_rect[:, 1]
        if cfg.rgbd:
            H, W = right_rect.shape
            x0 = torch.clamp(torch.floor(u).to(torch.int64), 0, W - 2)
            y0 = torch.clamp(torch.floor(v).to(torch.int64), 0, H - 2)
            ax = torch.clamp(u - x0, 0.0, 1.0)
            ay = torch.clamp(v - y0, 0.0, 1.0)
            d = right_rect
            z = (d[y0, x0] * (1 - ax) * (1 - ay) + d[y0, x0 + 1] * ax * (1 - ay)
                 + d[y0 + 1, x0] * (1 - ax) * ay + d[y0 + 1, x0 + 1] * ax * ay)
            ok = feats.mask & (z > cfg.depth_min) & (z < cfg.depth_max) & torch.isfinite(z)
            disparity = self.stereo.fx * self.stereo.baseline / torch.clamp(z, min=1e-3)
            uvd = torch.stack([u, u - disparity, v], -1)
            return StereoMeasurements(ids=feats.ids, uvs=uvd, mask=ok)
        if cfg.mono:
            uvd = torch.stack([u, torch.full_like(u, torch.nan), v], -1)
            return StereoMeasurements(ids=feats.ids, uvs=uvd, mask=feats.mask)
        uv_right, _, ok = match_stereo(
            left_rect, right_rect, feats.uv_rect, feats.mask,
            fx=self.stereo.fx, baseline=self.stereo.baseline,
            templ_cols=cfg.templ_cols, templ_rows=cfg.templ_rows,
            max_disparity=cfg.max_disparity, min_point_dist=cfg.min_point_dist,
            max_point_dist=cfg.max_point_dist, tolerance=cfg.templ_tolerance,
        )
        uvd = torch.stack([feats.uv_rect[:, 0], uv_right[:, 0], feats.uv_rect[:, 1]], -1)
        return StereoMeasurements(ids=feats.ids, uvs=uvd, mask=ok & feats.mask)

    # ------------------------------------------------------------------
    def track(self, state: FrontendState, left_img, imu_block: ImuBlock) -> Tracked:
        """The per-frame part up to the keyframe policy: pyramid,
        preintegration since the last keyframe, rotational prediction, LK
        from the last keyframe, the age gate, and the policy's inputs read
        back in one transfer. Takes one stream, or B streams stacked
        (`stack_trees`: a leading stream axis on the state's tensors, (B,
        H, W) images, (B, n) IMU blocks) in the same launches, LK
        included (one launch)."""
        return self.track_async(state, left_img, imu_block).read()

    def track_async(self, state: FrontendState, left_img, imu_block: ImuBlock) -> Tracked:
        """`track` with its work queued on the device and the policy
        inputs left there (`Tracked.read` copies them), so that a caller
        driving several devices can queue each before it waits on one."""
        with span("frontend.track"):
            return self._track(state, left_img, imu_block)

    def _track(self, state: FrontendState, left_img, imu_block: ImuBlock) -> Tracked:
        cfg = self.cfg
        with span("frontend.pyramid"):
            left_img = left_img.to(torch.float32)
            cur_pyr = of.build_pyramid(left_img, cfg.klt_max_level)

        with span("imu.preintegrate"):
            pim = imu.preintegrate(self.pim_params, imu_block, state.imu_bias, init=state.pim)
        R_cam = self.R_cam_body @ pim.delta_R @ self.R_cam_body.T
        R_cam_raw = self.R_leftcam_body @ pim.delta_R @ self.R_leftcam_body.T
        feats = state.lkf_features
        init_uv = of.predict_flow_rotational(
            feats.uv, feats.mask, R_cam_raw.mT[..., None, :, :], self.K_raw, self.K_raw_inv,
            self.left.width, self.left.height,
        )
        lk_kw = dict(win=cfg.klt_win, max_iter=cfg.klt_max_iter, eps=cfg.klt_eps,
                     device=self.device)
        with span("lk.track"):
            if cfg.lk_impl == "matmul":
                tracked_uv, ok = klt_track_cached_lk(state.lkf_templates, cur_pyr, init_uv,
                                                     feats.mask, **lk_kw)
            else:
                # The window rule admits no window over 54 px: "pallas"
                # tracks those with the gather rule.
                gather = cfg.lk_impl == "gather" or cfg.klt_win > LK_MAX_WIN
                tracked_uv, ok = klt_track_lk(
                    list(state.lkf_pyramid), cur_pyr, feats.uv, init_uv, feats.mask,
                    prev_grads=list(state.lkf_grads), **({"search_rows": None} if gather else {}),
                    **lk_kw)
        ok = ok & feats.mask & (feats.ages < cfg.max_feature_age)
        tracked_rect, tracked_versors = self._rect_and_versors(tracked_uv)
        cur_feats = TrackedFeatures(
            uv=tracked_uv, uv_rect=tracked_rect, versors=tracked_versors,
            ids=torch.where(ok, feats.ids, torch.full_like(feats.ids, -1)),
            ages=feats.ages, mask=ok,
        )
        disp = torch.linalg.norm(tracked_uv - feats.uv, dim=-1)
        policy = torch.stack([ok.sum(-1).to(torch.float32), _nanmedian_linear(disp, ok)], -1)
        return Tracked(cur_feats, cur_pyr, pim, R_cam, policy)

    def decide(self, state: FrontendState, trk: Tracked, stamp: float) -> tuple[bool, int]:
        """The keyframe policy (VisionImuFrontend::shouldBeKeyframe) of one
        stream on the host, from the state's host scalars and `trk.policy`:
        (is_keyframe, tracking status)."""
        cfg = self.cfg
        n_ok, med_disp = int(trk.policy[0]), float(trk.policy[1])
        dt = float(np.float32(stamp) - np.float32(state.lkf_stamp))
        time_min = dt >= cfg.min_intra_kf_time
        time_max = dt >= cfg.max_intra_kf_time
        enough_disp = med_disp >= cfg.disparity_threshold
        too_few = n_ok < max(cfg.min_features, 1)
        low_disparity = time_min and not enough_disp and not too_few
        first_time_low = state.last_status != TRACKING_LOW_DISPARITY
        max_disp_reached = med_disp > cfg.max_disparity_since_lkf
        is_keyframe = (
            time_max
            or too_few
            or (time_min and enough_disp)
            or (low_disparity and first_time_low)
            or max_disp_reached
        )
        status = (
            TRACKING_LOW_DISPARITY if low_disparity
            else TRACKING_FEW_MATCHES if too_few else TRACKING_VALID
        )
        return is_keyframe, status

    def finish(self, state: FrontendState, trk: Tracked, left_img, right_img, stamp: float,
               decision: tuple[bool, int]):
        """One stream's frame past `track` (`trk`: that stream's result)
        and `decide` (`decision`): the keyframe branch with the RANSAC
        inlier-count gate on the status, or the tracking frame's state;
        then the frame's outputs. A tracking frame reads only the state's
        host scalars and passes `trk`'s features and PIM on whole.
        Returns (state, outputs)."""
        with span("frontend.finish"):
            return self._finish(state, trk, left_img, right_img, stamp, decision)

    def _finish(self, state: FrontendState, trk: Tracked, left_img, right_img, stamp: float,
                decision: tuple[bool, int]):
        cfg = self.cfg
        is_keyframe, status = decision
        if is_keyframe:
            with span("frontend.keyframe_branch"):
                state, meas, extras = self._keyframe_branch(
                    state, trk.features, trk.pyramid, left_img.to(torch.float32),
                    right_img.to(torch.float32), trk.pim, trk.R_cam, stamp)
            ransac_few = extras["n_mono_inliers"] < cfg.min_mono_inliers or (
                not (cfg.mono or cfg.rgbd) and extras["n_stereo_inliers"] < cfg.min_stereo_inliers)
            if ransac_few and status == TRACKING_VALID:
                status = TRACKING_FEW_MATCHES
        else:
            state = replace(state, features=trk.features, pim=trk.pim,
                            frame_count=state.frame_count + 1)
            meas = None
            extras = {"n_mono_inliers": 0, "n_stereo_inliers": 0}
        state = replace(state, last_status=status)
        outputs = {
            "is_keyframe": is_keyframe,
            "status": status if is_keyframe else TRACKING_VALID,
            "n_tracked": int(trk.policy[0]),
            "median_disparity": float(trk.policy[1]),
            "pim": trk.pim,
            "measurements": meas,
            "stamp": stamp,
            **extras,
        }
        return state, outputs

    def process_frame(self, state: FrontendState, left_img, right_img, imu_block: ImuBlock,
                      stamp: float):
        """Track one frame; run the keyframe branch when the policy says so.
        Returns (state, outputs)."""
        trk = self.track(state, left_img, imu_block)
        return self.finish(state, trk, left_img, right_img, stamp,
                           self.decide(state, trk, stamp))

    # ------------------------------------------------------------------
    def _keyframe_branch(self, state, cur_feats, cur_pyr, left_img, right_img, pim, R_cam, stamp):
        cfg = self.cfg
        dev = self.device
        with span("frontend.rectify"):
            left_rect = self._remap_left(left_img)
            right_rect = self._right_rect(right_img)
        eye = torch.eye(3, dtype=torch.float32, device=dev)

        # 5. Mono RANSAC on lkf <-> cur bearings: 2-pt with the gyro
        # rotation, or 5-pt (StereoVisionImuFrontend.cpp:353-360).
        f_ref, f_cur = state.lkf_features.versors, cur_feats.versors
        pair_mask = cur_feats.mask & state.lkf_features.mask
        gen = torch.Generator(device=dev)
        gen.manual_seed(state.frame_count)
        with span("frontend.ransac_mono"):
            if cfg.use_2point_mono:
                t_mono, mono_inl, n_mono_t = ransac.ransac_2pt_mono(
                    f_ref, f_cur, pair_mask, R_cam, gen,
                    n_hyp=cfg.n_hyp_mono, threshold=cfg.ransac_threshold_mono,
                )
                R_mono = R_cam
            else:
                R_mono, t_mono, mono_inl, n_mono_t = ransac.ransac_5pt_mono(
                    f_ref, f_cur, pair_mask, gen,
                    n_hyp=cfg.n_hyp_mono, threshold=cfg.ransac_threshold_mono,
                )
            n_mono = int(n_mono_t)
        mono_trust = n_mono >= cfg.min_mono_inliers
        feats_inl = replace(
            cur_feats,
            mask=cur_feats.mask & (mono_inl | ~pair_mask | (not mono_trust)),
        )

        # 6+8: re-detect, merge, one stereo match (or depth lookup) for the
        # merged set.
        with span("frontend.detect"):
            uv_new, new_valid = self._detect(left_img, feats_inl)
        with span("frontend.merge"):
            feats_full, next_id = self._merge_detections(feats_inl, uv_new, new_valid,
                                                         state.next_id)
        with span("frontend.stereo_match"):
            meas_full = self._stereo_measurements(left_rect, right_rect, feats_full)

        if cfg.mono:
            # No stereo RANSAC: NaN-uR measurements of the refilled set.
            meas_out = meas_full
            n_stereo, R_stereo, t_vote = 0, eye, torch.zeros(3, device=dev)
        else:
            # 7. Stereo RANSAC on lkf <-> cur 3D points: 1-pt voting given
            # the rotation (Tracker.cpp:497-596) or 3-pt Arun (:667-742).
            with span("frontend.ransac_stereo"):
                tracked_mask = meas_full.mask & feats_inl.mask
                st = self.stereo
                p_cur = st.backproject_rect(meas_full.uvs)
                p_ref = st.backproject_rect(state.lkf_uvd)
                both = tracked_mask & state.lkf_uvd_mask
                if cfg.use_1point_stereo:
                    cov_cur = ransac.stereo_point_cov_from_rect(
                        st.fx, st.fy, st.cx, st.cy, st.baseline, meas_full.uvs, cfg.pixel_sigma)
                    cov_ref = ransac.stereo_point_cov_from_rect(
                        st.fx, st.fy, st.cx, st.cy, st.baseline, state.lkf_uvd, cfg.pixel_sigma)
                    t_vote, stereo_inl, n_stereo_t = ransac.voting_1pt_stereo(
                        p_ref, p_cur, cov_ref, cov_cur, both, R_cam,
                        threshold=cfg.ransac_threshold_stereo,
                    )
                    R_stereo = R_cam
                else:
                    R_stereo, t_vote, stereo_inl, n_stereo_t = ransac.ransac_3pt_arun(
                        p_ref, p_cur, both, gen, threshold=0.1)
                n_stereo = int(n_stereo_t)
            if n_stereo >= cfg.min_stereo_inliers:
                # Stereo-RANSAC outliers lose their track (Tracker.cpp:856-917).
                kill = both & ~stereo_inl
                feats_full = replace(
                    feats_full,
                    mask=feats_full.mask & ~kill,
                    ids=torch.where(kill, torch.full_like(feats_full.ids, -1), feats_full.ids),
                )
                meas_out = StereoMeasurements(
                    ids=feats_full.ids, uvs=meas_full.uvs, mask=meas_full.mask & ~kill)
            else:
                meas_out = replace(meas_full, ids=feats_full.ids)

        kf_state = replace(
            state,
            features=feats_full,
            lkf_features=feats_full,
            lkf_uvd=meas_out.uvs,
            lkf_uvd_mask=meas_out.mask,
            **self._lk_store(cur_pyr, feats_full),
            pim=imu.Pim.zero(state.imu_bias),
            lkf_stamp=_f32(stamp),
            next_id=next_id,
            frame_count=state.frame_count + 1,
            kf_count=state.kf_count + 1,
        )
        extras = {
            "n_mono_inliers": n_mono,
            "n_stereo_inliers": n_stereo,
            "t_stereo_vote": t_vote,
            "R_stereo": R_stereo,
            "t_mono": t_mono,
            "R_mono": R_mono,
            "left_rect": left_rect,  # the pipeline's frontend-image overlay
        }
        if cfg.lcd_features > 0:
            extras.update(self._lcd_extract(left_rect, left_rect if cfg.mono else right_rect))
        return kf_state, meas_out, extras

    def _lcd_extract(self, left_rect, right_rect) -> dict:
        """The loop-closure feature front half on this keyframe's
        rectified pair, already on the device."""
        return extract_lcd_features(self.stereo, left_rect, right_rect, self.cfg.lcd_features,
                                    self.cfg.lcd_min_distance)

    # ------------------------------------------------------------------
    def _merge_detections(self, feats, uv_new, new_valid, next_id: int):
        """Fill empty slots with new detections (ids from the running
        counter); age surviving tracks."""
        N = self.cfg.max_features
        free = ~feats.mask
        free_slots = torch.argsort((~free).to(torch.uint8), stable=True)
        rank = torch.cumsum(new_valid.to(torch.int64), 0) - 1
        can = new_valid & (rank < free.sum())
        slot = torch.where(can, free_slots[torch.clamp(rank, 0, N - 1)], torch.full_like(rank, N))
        new_ids = (next_id + rank).to(torch.int32)

        def scatter(table, values):
            padded = torch.cat([table, table[:1]], dim=0)
            padded[slot] = values
            return padded[:N]

        uv = scatter(feats.uv, uv_new)
        ids = scatter(feats.ids, torch.where(can, new_ids, torch.full_like(new_ids, -1)))
        ages = scatter(feats.ages, torch.zeros_like(feats.ages))
        mask = scatter(feats.mask, torch.ones_like(feats.mask))
        uv_rect_m, versors_m = self._rect_and_versors(uv)
        out = TrackedFeatures(
            uv=uv, uv_rect=uv_rect_m, versors=versors_m, ids=ids,
            ages=torch.where(mask, ages + 1, ages), mask=mask,
        )
        return out, next_id + int(can.sum())
