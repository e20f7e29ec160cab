"""Carry parameters and estimator state over from the JAX package.

VIO has no weights; what a run carries is its parameters and its
estimator state. These functions take them in the JAX package's layout as
plain Python data (nested dicts of numbers and numpy arrays, e.g. built
with `dataclasses.asdict` and `np.asarray`) and return the port's types.
Nothing here imports the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kimera_vio_tpu_torch import resolve_device
from kimera_vio_tpu_torch.backend.regular_vio import PlaneStates
from kimera_vio_tpu_torch.backend.smoother import LandmarkTable, Window, shard_landmarks
from kimera_vio_tpu_torch.common.types import ImuBias, TrackedFeatures, stack_trees, unstack_trees
from kimera_vio_tpu_torch.config import params as P
from kimera_vio_tpu_torch.frontend.imu_frontend import Pim
from kimera_vio_tpu_torch.frontend.vision_frontend import FrontendState
from kimera_vio_tpu_torch.mesher.plane_tracker import PlaneTracker
from kimera_vio_tpu_torch.parallel.fleet import FleetState, RowState

_PARAM_CLASSES = {
    "pipeline": P.PipelineParams,
    "imu": P.ImuParams,
    "left_cam": P.CameraParams,
    "right_cam": P.CameraParams,
    "frontend": P.FrontendParams,
    "backend": P.BackendParams,
    "lcd": P.LcdParams,
    "display": P.DisplayParams,
    "odometry": P.OdometryParams,
}


def _params(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    return cls(**{k: np.array(v) if isinstance(v, np.ndarray) else v for k, v in d.items()})


def vio_params_from_dict(d: dict) -> P.VioParams:
    """The JAX package's VioParams as a nested dict -> the port's
    VioParams (same fields, same values)."""
    kw = {}
    for f in dataclasses.fields(P.VioParams):
        v = d[f.name]
        if f.name in _PARAM_CLASSES and v is not None:
            v = _params(_PARAM_CLASSES[f.name], v)
        kw[f.name] = v
    return P.VioParams(**kw)


def _pim(d: dict, t) -> Pim:
    fields = [f.name for f in dataclasses.fields(Pim) if f.name != "bias_hat"]
    return Pim(
        **{k: t(d[k]) for k in fields},
        bias_hat=ImuBias(accel=t(d["bias_hat"]["accel"]), gyro=t(d["bias_hat"]["gyro"])),
    )


def _features(d: dict, t) -> TrackedFeatures:
    return TrackedFeatures(**{f.name: t(d[f.name]) for f in dataclasses.fields(TrackedFeatures)})


def state_from_numpy(window: dict, landmarks: dict, frontend: dict | None = None, *,
                     device: str | torch.device = "cuda"):
    """The JAX Window, LandmarkTable and (optionally) FrontendState as
    dicts of numpy arrays -> (Window, LandmarkTable, FrontendState | None)
    of the port on `device`.

    Every window field is carried, the external-odometry and
    between-stereo factor data included. A frontend state carries the LK
    data its tracker keeps: the keyframe pyramid and gradients (gather and
    pallas), or the matmul tracker's template cache (`lkf_templates`, a
    dict a level, None for a skipped level); one that holds neither is
    refused."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x), device=dev)

    win = Window(
        **{
            f.name: t(window[f.name])
            for f in dataclasses.fields(Window)
            if f.name not in ("n", "pim")
        },
        n=int(window["n"]),
        pim=_pim(window["pim"], t),
    )
    lmk = LandmarkTable(**{f.name: t(landmarks[f.name]) for f in dataclasses.fields(LandmarkTable)})
    if frontend is None:
        return win, lmk, None
    templates = tuple(_template_level(T, t) for T in frontend.get("lkf_templates", ()))
    if len(frontend["lkf_pyramid"]) == 0 and len(templates) == 0:
        raise ValueError("frontend state holds neither a keyframe pyramid nor LK templates")
    fe = FrontendState(
        features=_features(frontend["features"], t),
        lkf_features=_features(frontend["lkf_features"], t),
        lkf_pyramid=tuple(t(x) for x in frontend["lkf_pyramid"]),
        lkf_grads=tuple((t(gx), t(gy)) for gx, gy in frontend["lkf_grads"]),
        pim=_pim(frontend["pim"], t),
        imu_bias=ImuBias(accel=t(frontend["imu_bias"]["accel"]), gyro=t(frontend["imu_bias"]["gyro"])),
        lkf_uvd=t(frontend["lkf_uvd"]),
        lkf_uvd_mask=t(frontend["lkf_uvd_mask"]),
        lkf_stamp=float(np.float32(frontend["lkf_stamp"])),
        next_id=int(frontend["next_id"]),
        frame_count=int(frontend["frame_count"]),
        kf_count=int(frontend["kf_count"]),
        last_status=int(frontend["last_status"]),
        lkf_templates=templates,
    )
    return win, lmk, fe


def _template_level(T, t):
    """One level of the matmul tracker's template cache: a dict of arrays,
    or None (also as a 0-d object array, numpy's copy of None)."""
    if T is None or (isinstance(T, np.ndarray) and T.dtype == object and T.item() is None):
        return None
    return {k: t(v) for k, v in T.items()}


def fleet_state_from_numpy(fe_state: dict, win: dict, lmk: dict, *,
                           device: str | torch.device = "cuda", mesh=None) -> FleetState:
    """The JAX FleetState's leaves gathered to numpy (frontend state,
    window, landmark table as dicts of numpy arrays with a leading stream
    axis) -> the port's FleetState on a mesh (`FleetVio.mesh`, rows of
    devices; one row of `device` when omitted): each stream through
    `state_from_numpy` on its data row's first device, stacked per row,
    and each row's landmark tables split over its devices
    (`shard_landmarks`)."""
    mesh = [[resolve_device(device)]] if mesh is None else mesh
    n = np.asarray(win["n"]).shape[0]
    if n % len(mesh):
        raise ValueError(f"{n} streams do not divide over {len(mesh)} data rows")
    streams = list(zip(*(unstack_trees(t, n) for t in (win, lmk, fe_state))))
    per_row = n // len(mesh)
    rows = []
    for r, devs in enumerate(mesh):
        part = [state_from_numpy(w, lm, fe, device=devs[0])
                for w, lm, fe in streams[r * per_row:(r + 1) * per_row]]
        w, lm, fe = (stack_trees(list(p)) for p in zip(*part))
        rows.append(RowState(fe_state=fe, win=w, lmk=shard_landmarks(lm, devs)))
    return FleetState(rows=rows)


def planes_from_numpy(planes: dict, *, device: str | torch.device = "cuda") -> PlaneStates:
    """The JAX PlaneStates as a dict of numpy arrays (normal, d, mask) ->
    the port's PlaneStates on `device`."""
    dev = resolve_device(device)
    return PlaneStates(**{f.name: torch.as_tensor(np.array(planes[f.name]), device=dev)
                          for f in dataclasses.fields(PlaneStates)})


_TRACKER_STATE = ("P", "cos_tol", "dist_tol", "max_age_kf", "normals", "ds", "active",
                  "last_seen", "hits", "slot_pid", "_next_pid", "_kf_index")


def plane_tracker_from_state(state: dict) -> PlaneTracker:
    """A JAX PlaneTracker's attributes (its `vars()`) -> the port's
    PlaneTracker in the same state (host numpy, no device)."""
    tracker = PlaneTracker(max_planes=int(state["P"]))
    for name in _TRACKER_STATE:
        v = state[name]
        setattr(tracker, name, np.array(v) if isinstance(v, np.ndarray) else v)
    return tracker
