"""The plain reference that decides `correct`: what each of the port's
outputs should be, worked out from the benchmark's own scene, and the
numbers that compare the two.

The scene is known exactly (scene.py): the plane, the trajectory, the
rig. So the reference needs nothing the program made beyond the outputs
it judges and the questions those outputs answer (which keypoint a track
started from, which frames were keyframes):

  * a tracked keypoint (the LK layer: `lk_cached_kernel` tracking from
    the last keyframe's template cache): the keyframe's pixel is cast onto
    the plane at the keyframe's true pose and projected at the frame's
    true pose;
  * a landmark (the keyframe branch's stereo triangulation, refined by
    the smoother): a point of the plane z = plane_z in the world, which
    the ground-truth bootstrap shares with the program; the reference's
    own landmark of a keyframe's stereo measurement (uL, v) is the
    triangulation of uL and the true right column;
  * a keyframe state (the backend): the true pose; consecutive keyframes'
    relative rotation and translation are compared, which do not grow with
    the length of trajectory a run gets through.

Plain torch on the CPU in float64; `dtype` runs the same arithmetic in
another precision (the control: bfloat16). Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

# The numbers a cell's `correct` may hold to a limit.
NUMBERS = ("lk_px", "lmk_m", "lmk_px", "kf_rot_rad", "kf_trans_m")


def _t(x, dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(np.asarray(x, np.float64)).to(dtype)


def plane_points(uv, R_wc, p_wc, rig, plane_z: float, dtype=torch.float64):
    """World points (N, 3) where the left camera's rays through pixels uv
    (N, 2) meet the plane z = plane_z, and their depths (N,) in the
    camera."""
    uv, R, p = _t(uv, dtype), _t(R_wc, dtype), _t(p_wc, dtype)
    d_cam = torch.stack([(uv[:, 0] - rig.cx) / rig.fx, (uv[:, 1] - rig.cy) / rig.fy,
                         torch.ones_like(uv[:, 0])], -1)
    d_w = d_cam @ R.T
    s = (plane_z - p[2]) / d_w[:, 2]
    return p + s[:, None] * d_w, s


def project(X, R_wc, p_wc, rig, dtype=torch.float64):
    """Pixels (N, 2) and depths (N,) of world points X in the left camera."""
    X, R, p = _t(X, dtype), _t(R_wc, dtype), _t(p_wc, dtype)
    c = (X - p) @ R
    return torch.stack([rig.fx * c[:, 0] / c[:, 2] + rig.cx,
                        rig.fy * c[:, 1] / c[:, 2] + rig.cy], -1), c[:, 2]


def lk_truth(uv_kf, state_kf: dict, state_cur: dict, rig, plane_z: float,
             dtype=torch.float64):
    """Where keypoints at uv_kf in the keyframe lie in the current frame,
    and whether that is inside the image."""
    X, _ = plane_points(uv_kf, state_kf["rot"], state_kf["pos"], rig, plane_z, dtype)
    uv, z = project(X, state_cur["rot"], state_cur["pos"], rig, dtype)
    inside = (z > 0) & (uv[:, 0] >= 0) & (uv[:, 0] <= rig.width - 1) & \
        (uv[:, 1] >= 0) & (uv[:, 1] <= rig.height - 1)
    return uv, inside


def stereo_truth(uL, v, state_kf: dict, rig, plane_z: float, dtype=torch.float64):
    """The right pixel's column of stereo measurements (uL, v)."""
    uv = torch.stack([_t(uL, torch.float64), _t(v, torch.float64)], -1)
    _, z = plane_points(uv, state_kf["rot"], state_kf["pos"], rig, plane_z, dtype)
    return _t(uL, dtype) - rig.fx * rig.baseline / z


def triangulate(uL, uR, v, R_wc, p_wc, rig, dtype=torch.float64):
    """World points (N, 3) of stereo measurements (uL, uR, v) of a
    keyframe at pose (R_wc, p_wc): depth fx * baseline / (uL - uR) along
    the left pixel's ray."""
    uL, uR, v, R, p = (_t(x, dtype) for x in (uL, uR, v, R_wc, p_wc))
    z = rig.fx * rig.baseline / (uL - uR)
    c = torch.stack([(uL - rig.cx) / rig.fx * z, (v - rig.cy) / rig.fy * z, z], -1)
    return c @ R.T + p


def disparity_error(X, state_kf: dict, rig, plane_z: float) -> torch.Tensor:
    """For world points X (N, 3) seen from a keyframe's true pose: the
    disparity (px) each implies, against the plane's along the same ray,
    fx * baseline * |1 / z - 1 / z_plane|, where the depths are both
    in front of the camera (a stereo layer's error in its own units, the
    same at any depth). Float64."""
    X = _t(X, torch.float64)
    R, p = _t(state_kf["rot"], torch.float64), _t(state_kf["pos"], torch.float64)
    d = X - p
    z = (d @ R)[:, 2]
    z_plane = z * (plane_z - p[2]) / d[:, 2]
    ok = (z > 0) & (z_plane > 0)
    return (rig.fx * rig.baseline * (1.0 / z - 1.0 / z_plane)).abs()[ok]


def relative(Ra, pa, Rb, pb, dtype=torch.float64):
    """b relative to a: (R_a^T R_b, R_a^T (p_b - p_a))."""
    Ra, pa, Rb, pb = (_t(x, dtype) for x in (Ra, pa, Rb, pb))
    return Ra.T @ Rb, Ra.T @ (pb - pa)


def rot_angle(R) -> float:
    """Angle (rad) of a rotation matrix, in float64."""
    R = torch.as_tensor(R, dtype=torch.float64)
    c = torch.clamp((torch.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    # acos loses digits near 0: the skew part's norm gives the sine.
    s = 0.5 * torch.linalg.norm(torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                                             R[1, 0] - R[0, 1]]))
    return float(torch.atan2(s, c))


def _median(x) -> float | None:
    x = [float(a) for a in x]
    return float(np.median(x)) if x else None


def judge(capture: dict, truth, rig, plane_z: float, dtype=torch.float64,
          answers_from_reference: bool = False) -> dict:
    """The numbers compared, from a run's `capture`:

      * "tracks": [(frame, kf_frame, stream, uv_kf (N, 2), uv (N, 2), ok (N,))]
        sampled tracking frames (numpy, host);
      * "landmarks": [(kf_frame, stream, points (L, 3), valid (L,),
        uv (N, 2), mask (N,))] each keyframe of the window: the program's
        landmarks in the world, and the keyframe's stereo measurements'
        left pixels (uL, v);
      * "keyframes": {stream: [(frame, R (3, 3), p (3,), v (3,), bias (6,))]}
        every keyframe of the window in order, with the one before it.

    `truth(frame, stream, dtype=float64)` gives the state of a stream at a
    frame (scene.Scene.state), exact in float64. With
    `answers_from_reference` the program's answers are replaced by the
    reference's own, every step from the frame's time on computed in
    `dtype` (the control); otherwise `dtype` is unused and the program's
    are judged.

    Returns {name: value} for `NUMBERS` (None where the run had nothing of
    that kind), each the largest over streams of the stream's median, so
    that one stream gone wrong in a fleet shows whatever the others do:
    `lk_px` px from the true track; `lmk_m` a valid landmark's distance
    from the plane, `lmk_px` the same error as disparity (px) from the
    keyframe's true pose (disparity_error); `kf_rot_rad` and `kf_trans_m`, consecutive keyframes'
    relative pose from the true one. Beside them the counts, each stream's
    medians (`*_streams`) and, not compared, `kf_vel_mps` (speed error)
    and `kf_bias` (bias norm; the scene's IMU carries none)."""
    f64 = torch.float64
    errs = {k: {} for k in ("lk", "lmk", "lmk_px", "rot", "tr", "vel", "bias")}

    def add(kind, stream, values):
        errs[kind].setdefault(stream, []).extend(values)

    for frame, kf, stream, uv_kf, uv, ok in capture["tracks"]:
        want, inside = lk_truth(uv_kf, truth(kf, stream), truth(frame, stream), rig, plane_z, f64)
        if answers_from_reference:
            uv = lk_truth(uv_kf, truth(kf, stream, dtype), truth(frame, stream, dtype), rig,
                          plane_z, dtype)[0].to(f64)
        sel = torch.as_tensor(np.asarray(ok, bool)) & inside
        add("lk", stream, torch.linalg.norm(_t(uv, f64) - want, dim=-1)[sel].tolist())
    for kf, stream, pts, valid, uv, mask in capture["landmarks"]:
        if answers_from_reference:
            uv = np.asarray(uv, np.float64)[np.asarray(mask, bool)]
            s = truth(kf, stream, dtype)
            uR = stereo_truth(uv[:, 0], uv[:, 1], s, rig, plane_z, dtype)
            pts = triangulate(uv[:, 0], uR, uv[:, 1], s["rot"], s["pos"], rig, dtype).to(f64)
        else:
            pts = _t(pts, f64)[torch.as_tensor(np.asarray(valid, bool))]
        add("lmk", stream, (pts[:, 2] - plane_z).abs().tolist())
        add("lmk_px", stream, disparity_error(pts, truth(kf, stream), rig, plane_z).tolist())
    for stream, kfs in capture["keyframes"].items():
        for (fa, Ra, pa, va, ba), (fb, Rb, pb, vb, bb) in zip(kfs, kfs[1:]):
            ta, tb = truth(fa, stream), truth(fb, stream)
            if answers_from_reference:
                la, lb = truth(fa, stream, dtype), truth(fb, stream, dtype)
                Ra, pa, Rb, pb, vb = la["rot"], la["pos"], lb["rot"], lb["pos"], lb["vel"]
            dR, dp = relative(Ra, pa, Rb, pb, f64)
            dR_t, dp_t = relative(ta["rot"], ta["pos"], tb["rot"], tb["pos"], f64)
            add("rot", stream, [rot_angle(dR_t.T @ dR)])
            add("tr", stream, [float(torch.linalg.norm(dp - dp_t))])
            add("vel", stream, [float(torch.linalg.norm(_t(vb, f64) - _t(tb["vel"], f64)))])
            add("bias", stream, [float(torch.linalg.norm(_t(bb, f64)))])

    def per_stream(kind):
        return [_median(v) for _, v in sorted(errs[kind].items()) if v]

    def worst(kind):
        meds = per_stream(kind)
        return max(meds) if meds else None

    def count(kind):
        return sum(len(v) for v in errs[kind].values())

    return {"lk_px": worst("lk"), "lmk_m": worst("lmk"), "lmk_px": worst("lmk_px"),
            "kf_rot_rad": worst("rot"),
            "kf_trans_m": worst("tr"),
            "lk_tracks": count("lk"), "landmarks": count("lmk"), "kf_pairs": count("rot"),
            "kf_vel_mps": worst("vel"), "kf_bias": worst("bias"),
            "lk_px_streams": per_stream("lk"), "lmk_m_streams": per_stream("lmk"),
            "lmk_px_streams": per_stream("lmk_px"),
            "kf_rot_streams": per_stream("rot"), "kf_trans_streams": per_stream("tr")}
