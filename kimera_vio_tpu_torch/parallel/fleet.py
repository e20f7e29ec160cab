"""FleetVio: B robot streams through one batched frame step on one card.

Port of kimera_vio_tpu/parallel/fleet.py, the JAX package's serving
layer: B independent stereo + IMU streams (a fleet of identical robots:
one camera rig, one parameter set) advance together, one frame each per
`step`.

The JAX fleet vmaps its fused frame program, whose backend is gated on
the device. Here the keyframe decision is a host branch and the backend
syncs in every Gauss-Newton iteration, so the frame step is split
instead:

  * the per-frame part runs once for all B streams in the same launches
    (`StereoFrontend.track` on stacked state): (B, H, W) pyramids and
    gradients, (B, n) preintegration, rotational prediction, ONE LK
    kernel launch for the B x N keypoints, the age gate, and one host
    transfer of the (B, 2) policy inputs;
  * the keyframe policy is evaluated per stream on the host
    (`StereoFrontend.decide`, as for one stream), from each stream's own
    stamps, and `StereoFrontend.finish` ends each stream's frame;
  * each keyframing stream runs the single-stream keyframe half on its
    slice of the state (`finish`'s keyframe branch, then
    `StereoImuPipeline._keyframe_half`: pose guess, backend, bias
    feedback), written into a copy of the stacked state.

Each stream gives what its own single-stream run (`_init_stream`, then
`_step`) gives. Streams that do not keyframe report the newest window
slot's state, zero landmark points and no keypoint measurements, as the
JAX fleet's `skip_backend` does. As in the JAX fleet there is no
time-origin rebase, ground-truth bootstrap, loop closure, mesher or
backend-health stop.

The JAX fleet also shards streams (`data`) and landmark tables (`model`)
over a device mesh; with one card there is no mesh here, and
`model_shards > 1` raises (ROADMAP.md queues the multi-card axes).
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from kimera_vio_tpu_torch import resolve_device
from kimera_vio_tpu_torch.backend.smoother import LandmarkTable, Window
from kimera_vio_tpu_torch.common.types import (
    ImuBlock,
    NavState,
    replace,
    stack_trees,
    tree_clone,
    tree_set,
    unstack_trees,
)
from kimera_vio_tpu_torch.config.params import VioParams
from kimera_vio_tpu_torch.frontend.vision_frontend import FrontendState
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline


@dataclass
class FleetState:
    """Every stream's state, stacked (`stack_trees`): a leading stream
    axis on every tensor; the frontend's and window's host scalars
    (`lkf_stamp`, `next_id`, `frame_count`, `kf_count`, `last_status`,
    `n`) as numpy arrays of one value per stream."""

    fe_state: FrontendState
    win: Window
    lmk: LandmarkTable


class FleetVio:
    """B stereo + IMU streams of one rig and parameter set on one device
    (CUDA by default; raises without it unless `device="cpu"`)."""

    def __init__(self, params: VioParams, n_streams: int, *,
                 device: str | torch.device = "cuda", model_shards: int = 1):
        if model_shards != 1:
            raise ValueError(
                f"model_shards={model_shards}: the landmark tables are not sharded on one "
                "card; the multi-card data / model axes are queued in ROADMAP.md")
        if n_streams < 1:
            raise ValueError(f"n_streams={n_streams}: need at least one stream")
        self.device = resolve_device(device)
        self.B = n_streams
        # One pipeline supplies the frontend, the backend and all configs;
        # its own run state is never used.
        self._pipe = StereoImuPipeline(params, parallel_run=False, device=self.device)

    # ------------------------------------------------------------------
    def _batched(self, name: str, x, dtype=None) -> torch.Tensor:
        t = torch.as_tensor(x, dtype=dtype, device=self.device)
        if t.dim() == 0 or t.shape[0] != self.B:
            raise ValueError(f"{name}: leading axis {tuple(t.shape)[:1]} != {self.B} streams")
        return t

    def init(self, lefts, rights, navs: NavState | None = None, biases=None) -> FleetState:
        """Bootstrap every stream from its first stereo pair at stamp 0.

        lefts / rights: (B, H, W). navs: a NavState with (B, 3, 3) / (B, 3)
        leaves, identity when omitted; biases: (B, 6) [accel, gyro], zero
        when omitted."""
        B, dev = self.B, self.device
        lefts, rights = self._batched("lefts", lefts), self._batched("rights", rights)
        if navs is None:
            navs = NavState(rot=torch.eye(3, device=dev).expand(B, 3, 3),
                            pos=torch.zeros((B, 3), device=dev),
                            vel=torch.zeros((B, 3), device=dev))
        navs = NavState(*(self._batched(f"navs.{k}", getattr(navs, k), torch.float32)
                          for k in ("rot", "pos", "vel")))
        biases = torch.zeros((B, 6), device=dev) if biases is None else biases
        biases = self._batched("biases", biases, torch.float32)
        streams = [self._pipe._init_stream(lefts[b], rights[b], 0.0, nav, biases[b])
                   for b, nav in enumerate(unstack_trees(navs, B))]
        fe_state, win, lmk = (stack_trees(list(part)) for part in zip(*streams))
        return FleetState(fe_state=fe_state, win=win, lmk=lmk)

    def step(self, state: FleetState, lefts, rights, imu_blocks: ImuBlock, stamps):
        """One frame for every stream.

        lefts / rights: (B, H, W); imu_blocks: an ImuBlock with (B, n, ...)
        leaves; stamps: (B,) float32 seconds since `init`. Returns (new
        state, out); the state passed in is left as it was. `out` holds,
        per stream, `is_keyframe`, `n_tracked`, `median_disparity`,
        `n_mono_inliers`, `n_stereo_inliers` (host numpy) and `rot`,
        `pos`, `vel`, `bias`, `lmk_points`, `lmk_valid`, `lmk_ids`,
        `kp_uv`, `kp_ids`, `kp_mask`, `n_recovered` (tensors with a
        leading stream axis)."""
        pipe, fe, B = self._pipe, self._pipe.frontend, self.B
        lefts, rights = self._batched("lefts", lefts), self._batched("rights", rights)
        blocks = ImuBlock(*(self._batched(f"imu_blocks.{k}", getattr(imu_blocks, k))
                            for k in ("acc", "gyr", "dt", "mask")))
        stamps = np.asarray(stamps, np.float32)
        if stamps.shape != (B,):
            raise ValueError(f"stamps: shape {stamps.shape} != ({B},)")
        stamps = [float(s) for s in stamps]

        fs = state.fe_state
        trk = fe.track(fs, lefts, blocks)  # every stream, one LK launch
        # Every stream moves on as a tracking frame; the keyframing ones
        # overwrite their rows below, in copies made at the first of them.
        new_fs = replace(fs, features=trk.features, pim=trk.pim,
                         frame_count=fs.frame_count.copy(), last_status=fs.last_status.copy())
        win, lmk, views = state.win, state.lmk, None
        scalars = [f.name for f in fields(fs) if isinstance(getattr(fs, f.name), np.ndarray)]
        fe_outs, kf_rows = [], {}
        for b in range(B):
            # Stream b's host scalars over the stacked tensors: all that the
            # policy and a tracking frame read. A keyframe takes the
            # stream's own views (one `unbind` a leaf, at the frame's first
            # keyframe, when the copies are made too).
            fs_b = replace(fs, **{k: getattr(fs, k)[b].item() for k in scalars})
            trk_b = replace(trk, policy=trk.policy[b])
            decision = fe.decide(fs_b, trk_b, stamps[b])
            if decision[0]:
                if views is None:
                    views = unstack_trees(fs, B), unstack_trees(trk, B)
                    new_fs, win, lmk = (tree_clone(t) for t in (new_fs, win, lmk))
                fs_b, trk_b = views[0][b], views[1][b]
            st_b, fe_out = fe.finish(fs_b, trk_b, lefts[b], rights[b], stamps[b], decision)
            if decision[0]:
                st_b, win_b, lmk_b, _, bout = pipe._keyframe_half(
                    st_b, unstack_trees(win, B)[b], unstack_trees(lmk, B)[b], fe_out, stamps[b])
                tree_set(new_fs, b, st_b)
                tree_set(win, b, win_b)
                tree_set(lmk, b, lmk_b)
                kf_rows[b] = (bout, fe_out["measurements"])
            else:  # its tensors are the batched part's, already in new_fs
                new_fs.frame_count[b] = st_b.frame_count
                new_fs.last_status[b] = st_b.last_status
            fe_outs.append(fe_out)
        out = self._outputs(win, lmk, trk.features, kf_rows)
        host = {"is_keyframe": bool, "n_tracked": np.int64, "median_disparity": np.float32,
                "n_mono_inliers": np.int64, "n_stereo_inliers": np.int64}
        out.update({k: np.array([o[k] for o in fe_outs], dt) for k, dt in host.items()})
        return FleetState(fe_state=new_fs, win=win, lmk=lmk), out

    def _outputs(self, win, lmk, feats, kf_rows: dict) -> dict:
        """The per-stream device outputs, stacked: the backend's for the
        keyframing streams (`kf_rows`: stream -> (backend outputs,
        measurements)), `skip_backend`'s for the others."""
        L = lmk.ids.shape[-1]
        no_points = torch.zeros((L, 3), device=self.device)
        no_valid = torch.zeros(L, dtype=torch.bool, device=self.device)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        rows = []
        for b in range(self.B):
            if b in kf_rows:
                bout, meas = kf_rows[b]
                rows.append((bout["rot"], bout["pos"], bout["vel"], bout["bias"],
                             bout["lmk_points"], bout["lmk_valid"], bout["lmk_ids"],
                             meas.uvs[:, [0, 2]], meas.ids, meas.mask,
                             torch.as_tensor(bout["n_recovered"], dtype=torch.int32,
                                             device=self.device)))
            else:
                slot = max(int(win.n[b]) - 1, 0)
                rows.append((win.rot[b, slot], win.pos[b, slot], win.vel[b, slot],
                             win.bias[b, slot], no_points, no_valid, lmk.ids[b],
                             feats.uv_rect[b], feats.ids[b], torch.zeros_like(feats.mask[b]),
                             zero))
        names = ("rot", "pos", "vel", "bias", "lmk_points", "lmk_valid", "lmk_ids", "kp_uv",
                 "kp_ids", "kp_mask", "n_recovered")
        return {k: torch.stack(col) for k, col in zip(names, zip(*rows))}
