"""FleetVio: B robot streams through one batched frame step, over a mesh
of devices.

Port of kimera_vio_tpu/parallel/fleet.py, the JAX package's serving
layer: B independent stereo + IMU streams (a fleet of identical robots:
one camera rig, one parameter set) advance together, one frame each per
`step`.

The JAX fleet vmaps its fused frame program, whose backend is gated on
the device. Here the keyframe decision is a host branch and the backend
syncs in every Gauss-Newton iteration, so the frame step is split
instead:

  * the per-frame part runs once for all of a data row's streams in the
    same launches (`StereoFrontend.track_async` on stacked state): (B, H,
    W) pyramids and gradients, (B, n) preintegration, rotational
    prediction, ONE LK kernel launch for the B x N keypoints, the age
    gate, and one host transfer of the (B, 2) policy inputs;
  * the keyframe policy is evaluated per stream on the host
    (`StereoFrontend.decide`, as for one stream), from each stream's own
    stamps, and `StereoFrontend.finish` ends each stream's frame;
  * each keyframing stream runs the single-stream keyframe half on its
    slice of the state (`finish`'s keyframe branch, then
    `StereoImuPipeline._keyframe_half`: pose guess, backend, bias
    feedback), written into a copy of its row's stacked state.

Each stream gives what its own single-stream run (`_init_stream`, then
`_step`) gives. Streams that do not keyframe report the newest window
slot's state, zero landmark points and no keypoint measurements, as the
JAX fleet's `skip_backend` does. As in the JAX fleet there is no
time-origin rebase, ground-truth bootstrap, loop closure, mesher or
backend-health stop.

The mesh has the JAX fleet's two axes, `data` x `model` (`fleet_mesh`):
an explicit device list reshaped row-major to (len // model_shards,
model_shards), or every visible card (one device for the CPU) with
`model_shards` shrunk as the JAX fleet shrinks it.

  * `data`: row r owns streams [r B/D, (r+1) B/D) end to end. It has its
    own StereoImuPipeline on its first device (the camera, remap taps and
    BackendConfig tensors live on one device) and its own batched frame
    step: one LK launch per row per fleet frame. No data moves between
    rows.
  * `model`: each stream's landmark table is split along its landmark
    axis over the M devices of its row (`ShardedLandmarkTable`: shard m
    holds rows [m L/M, (m+1) L/M)). The smoother assigns rows over the
    whole table, each shard linearizes its landmarks against a copy of
    the window, and the partial smart-factor systems are summed on the
    row's first device in shard order (the JAX fleet's psum); the solve
    stays there. The frontend state and the window stay whole on the
    row's first device. Where M does not divide the landmark count L,
    the JAX fleet leaves the table unsplit (`_shard` splits an axis over
    `model` only when it divides), and so does the port: the plain table
    lies on the row's first device, and the row's other devices hold
    nothing where XLA would replicate it. The JAX fleet also lets XLA
    split any other array whose second axis divides over `model`. Both
    are placement, not semantics: the port splits the landmark tables
    only, and only where they divide.

A device may repeat in an explicit list (["cpu"] * 4 in the tests,
["cuda:0"] * 4 on one card): the counterpart of the JAX tests' virtual
CPU devices, it runs every line of the sharding code. As in the JAX
mesh, one controller drives every device: `step` first queues every
row's batched frame step, then reads each row's policy inputs, then
runs each stream's rest of the frame, row after row. So on distinct
cards the rows' batched frame steps overlap, and their keyframe halves
do not: each row's run after the previous row's on the one host thread.

Each `step` is a span of the port's recorder (utils/stats.py, off unless
turned on): `fleet.step` with the step's number, a `fleet.stream` with
the stream's index around each stream's rest of the frame (the keyframe
branch and half inside it), and `fleet.outputs`.

Under the switches the JAX fleet's fused step reads, `step` also returns
that step's optional outputs (`_switched_outputs`): the LCD features
under `use_lcd`, the visual rotation angle under
`do_fine_imu_camera_temporal_sync`, the stereo relative pose and the
preintegration under `auto_initialize: 2`. As in the JAX fleet, nothing
consumes them: the fleet runs no loop closure, time aligner or online
initializer.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from kimera_vio_tpu_torch import resolve_device
from kimera_vio_tpu_torch.backend.smoother import (
    LandmarkTable,
    ShardedLandmarkTable,
    Window,
    shard_landmarks,
)
from kimera_vio_tpu_torch.common.geometry import so3_log
from kimera_vio_tpu_torch.common.types import (
    ImuBlock,
    NavState,
    replace,
    stack_trees,
    tree_clone,
    tree_map,
    tree_set,
    unstack_trees,
)
from kimera_vio_tpu_torch.config.params import VioParams
from kimera_vio_tpu_torch.frontend.vision_frontend import FrontendState
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline
from kimera_vio_tpu_torch.utils.stats import span


@dataclass
class RowState:
    """One data row's streams, stacked (`stack_trees`): a leading stream
    axis on every tensor; the frontend's and window's host scalars
    (`lkf_stamp`, `next_id`, `frame_count`, `kf_count`, `last_status`,
    `n`) as numpy arrays of one value per stream. The frontend state and
    window lie on the row's first device, each landmark shard on its
    own."""

    fe_state: FrontendState
    win: Window
    lmk: LandmarkTable | ShardedLandmarkTable


@dataclass
class FleetState:
    """Every stream's state: one RowState per data row, in row order.
    With one data row, `fe_state`, `win` and `lmk` read that row's."""

    rows: list

    def _row(self) -> RowState:
        if len(self.rows) != 1:
            raise AttributeError(f"a FleetState of {len(self.rows)} data rows: read .rows[r]")
        return self.rows[0]

    fe_state = property(lambda self: self._row().fe_state)
    win = property(lambda self: self._row().win)
    lmk = property(lambda self: self._row().lmk)


def _indexed(dev: torch.device) -> torch.device:
    """A bare "cuda" as the card it means (the current one)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def fleet_mesh(device: str | torch.device = "cuda", devices=None,
               model_shards: int = 1) -> list[list[torch.device]]:
    """The (data, model) mesh as rows of devices.

    `devices` given: reshaped row-major to (len // model_shards,
    model_shards), as the JAX fleet reshapes its device array; a device
    may repeat. `devices=None`: every visible card for a bare "cuda" (one
    device for "cpu" or an indexed card), and `model_shards` shrunk to at
    most the device count and then down to a divisor of it, the JAX
    fleet's rule for its default mesh."""
    if model_shards < 1:
        raise ValueError(f"model_shards={model_shards}: need at least one shard")
    if devices is None:
        dev = resolve_device(device)
        devs = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                if dev.type == "cuda" and dev.index is None else [dev])
        model_shards = min(model_shards, len(devs))
        while len(devs) % model_shards:
            model_shards -= 1
    else:
        devs = [_indexed(resolve_device(d)) for d in devices]
        if not devs or len(devs) % model_shards:
            raise ValueError(f"{len(devs)} devices do not reshape to rows of "
                             f"model_shards={model_shards}")
    return [devs[i:i + model_shards] for i in range(0, len(devs), model_shards)]


class FleetVio:
    """B stereo + IMU streams of one rig and parameter set over a (data,
    model) mesh of devices (`fleet_mesh`; by default every visible card,
    CUDA unless `device="cpu"`, and CUDA raises without it). `mesh` holds
    the rows of devices it runs on."""

    def __init__(self, params: VioParams, n_streams: int, *,
                 device: str | torch.device = "cuda", devices=None, model_shards: int = 1):
        if n_streams < 1:
            raise ValueError(f"n_streams={n_streams}: need at least one stream")
        self.mesh = fleet_mesh(device, devices, model_shards)
        D = len(self.mesh)
        if n_streams % D:
            raise ValueError(f"n_streams={n_streams} must divide over the data axis "
                             f"({D} shards)")
        self.B = n_streams
        self.device = self.mesh[0][0]  # where `step` gathers its outputs
        Br = n_streams // D
        self._slices = [slice(r * Br, (r + 1) * Br) for r in range(D)]
        # One pipeline per data row supplies the frontend, the backend and
        # all configs on the row's first device; its own run state is never
        # used.
        self._pipes = [StereoImuPipeline(params, parallel_run=False, device=row[0])
                       for row in self.mesh]
        self._pipe = self._pipes[0]
        self._n_steps = 0  # `step` calls so far: the `step` id of their spans

    # ------------------------------------------------------------------
    def _batched(self, name: str, x, dtype=None) -> torch.Tensor:
        t = torch.as_tensor(x, dtype=dtype)
        if t.dim() == 0 or t.shape[0] != self.B:
            raise ValueError(f"{name}: leading axis {tuple(t.shape)[:1]} != {self.B} streams")
        return t

    def init(self, lefts, rights, navs: NavState | None = None, biases=None) -> FleetState:
        """Bootstrap every stream from its first stereo pair at stamp 0.

        lefts / rights: (B, H, W). navs: a NavState with (B, 3, 3) / (B, 3)
        leaves, identity when omitted; biases: (B, 6) [accel, gyro], zero
        when omitted."""
        B = self.B
        lefts, rights = self._batched("lefts", lefts), self._batched("rights", rights)
        if navs is None:
            navs = tree_map(lambda x: x.expand(B, *x.shape), NavState.identity("cpu"))
        navs = NavState(*(self._batched(f"navs.{k}", getattr(navs, k), torch.float32)
                          for k in ("rot", "pos", "vel")))
        biases = torch.zeros((B, 6)) if biases is None else biases
        biases = self._batched("biases", biases, torch.float32)
        rows = []
        for pipe, devs, sl in zip(self._pipes, self.mesh, self._slices):
            dev = devs[0]
            streams = [pipe._init_stream(lefts[b].to(dev), rights[b].to(dev), 0.0,
                                         tree_map(lambda x: x.to(dev), nav), biases[b].to(dev))
                       for b, nav in zip(range(sl.start, sl.stop),
                                         unstack_trees(navs, B)[sl])]
            fe_state, win, lmk = (stack_trees(list(part)) for part in zip(*streams))
            rows.append(RowState(fe_state=fe_state, win=win, lmk=shard_landmarks(lmk, devs)))
        return FleetState(rows=rows)

    def step(self, state: FleetState, lefts, rights, imu_blocks: ImuBlock, stamps):
        """One frame for every stream.

        lefts / rights: (B, H, W); imu_blocks: an ImuBlock with (B, n, ...)
        leaves; stamps: (B,) float32 seconds since `init`. Returns (new
        state, out); the state passed in is left as it was. `out` holds,
        per stream, `is_keyframe`, `n_tracked`, `median_disparity`,
        `n_mono_inliers`, `n_stereo_inliers` (host numpy) and `rot`,
        `pos`, `vel`, `bias`, `lmk_points`, `lmk_valid`, `lmk_ids`,
        `kp_uv`, `kp_ids`, `kp_mask`, `n_recovered` and, under their
        switches, the fields of `_switched_outputs` (tensors with a leading
        stream axis, gathered on the mesh's first device; the landmark
        fields with the shards concatenated in row order)."""
        B = self.B
        lefts, rights = self._batched("lefts", lefts), self._batched("rights", rights)
        blocks = ImuBlock(*(self._batched(f"imu_blocks.{k}", getattr(imu_blocks, k))
                            for k in ("acc", "gyr", "dt", "mask")))
        stamps = np.asarray(stamps, np.float32)
        if stamps.shape != (B,):
            raise ValueError(f"stamps: shape {stamps.shape} != ({B},)")
        if len(state.rows) != len(self.mesh):
            raise ValueError(f"state: {len(state.rows)} data rows != the mesh's {len(self.mesh)}")
        stamps = [float(s) for s in stamps]
        self._n_steps += 1
        with span("fleet.step", step=self._n_steps):
            # Every row's batched frame step is queued before any row is
            # waited on, then each row's policy inputs are read back.
            inputs, trks = [], []
            for pipe, devs, sl, row in zip(self._pipes, self.mesh, self._slices, state.rows):
                dev = devs[0]
                inputs.append((lefts[sl].to(dev), rights[sl].to(dev)))
                trks.append(pipe.frontend.track_async(row.fe_state, inputs[-1][0],
                                                      tree_map(lambda x: x[sl].to(dev), blocks)))
            trks = [trk.read() for trk in trks]
            rows, outs, fe_outs = [], [], []
            for pipe, sl, row, trk, (lefts_r, rights_r) in zip(
                    self._pipes, self._slices, state.rows, trks, inputs):
                row, out, fo = self._row_step(pipe, row, trk, lefts_r, rights_r, stamps[sl],
                                              sl.start)
                rows.append(row)
                outs.append(out)
                fe_outs += fo
            with span("fleet.outputs"):
                out = {k: torch.cat([o[k].to(self.device) for o in outs]) for k in outs[0]}
                host = {"is_keyframe": bool, "n_tracked": np.int64,
                        "median_disparity": np.float32, "n_mono_inliers": np.int64,
                        "n_stereo_inliers": np.int64}
                out.update({k: np.array([o[k] for o in fe_outs], dt) for k, dt in host.items()})
        return FleetState(rows=rows), out

    def _row_step(self, pipe: StereoImuPipeline, row: RowState, trk, lefts, rights,
                  stamps: list, first: int) -> tuple:
        """One data row's frame past its batched frame step (`trk`, read):
        each stream's policy and frame end, and the keyframing streams'
        keyframe halves; `first` is the fleet's index of the row's first
        stream. Returns (new row state, device outputs, frontend outputs
        per stream)."""
        fe, B = pipe.frontend, len(stamps)
        fs = row.fe_state
        # Every stream moves on as a tracking frame; the keyframing ones
        # overwrite their rows below, in copies made at the first of them.
        new_fs = replace(fs, features=trk.features, pim=trk.pim,
                         frame_count=fs.frame_count.copy(), last_status=fs.last_status.copy())
        win, lmk, views = row.win, row.lmk, None
        scalars = [f.name for f in fields(fs) if isinstance(getattr(fs, f.name), np.ndarray)]
        fe_outs, kf_rows = [], {}
        for b in range(B):
            with span("fleet.stream", b=first + b):
                # Stream b's host scalars over the stacked tensors: all that
                # the policy and a tracking frame read. A keyframe takes the
                # stream's own views (one `unbind` a leaf, at the row's first
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
                        st_b, unstack_trees(win, B)[b], unstack_trees(lmk, B)[b], fe_out,
                        stamps[b])
                    tree_set(new_fs, b, st_b)
                    tree_set(win, b, win_b)
                    tree_set(lmk, b, lmk_b)
                    kf_rows[b] = (bout, fe_out["measurements"])
                else:  # its tensors are the batched part's, already in new_fs
                    new_fs.frame_count[b] = st_b.frame_count
                    new_fs.last_status[b] = st_b.last_status
                fe_outs.append(fe_out)
        with span("fleet.outputs"):
            out = self._outputs(pipe.device, win, lmk, trk.features, kf_rows)
            out.update(self._switched_outputs(pipe, fe_outs, trk.pim))
        return RowState(fe_state=new_fs, win=win, lmk=lmk), out, fe_outs

    @staticmethod
    def _outputs(dev, win, lmk, feats, kf_rows: dict) -> dict:
        """A row's per-stream device outputs, stacked: the backend's for the
        keyframing streams (`kf_rows`: stream -> (backend outputs,
        measurements)), `skip_backend`'s for the others."""
        ids = lmk.ids
        B, L = ids.shape
        no_points = torch.zeros((L, 3), device=dev)
        no_valid = torch.zeros(L, dtype=torch.bool, device=dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        rows = []
        for b in range(B):
            if b in kf_rows:
                bout, meas = kf_rows[b]
                rows.append((bout["rot"], bout["pos"], bout["vel"], bout["bias"],
                             bout["lmk_points"], bout["lmk_valid"], bout["lmk_ids"],
                             meas.uvs[:, [0, 2]], meas.ids, meas.mask,
                             torch.as_tensor(bout["n_recovered"], dtype=torch.int32, device=dev)))
            else:
                slot = max(int(win.n[b]) - 1, 0)
                rows.append((win.rot[b, slot], win.pos[b, slot], win.vel[b, slot],
                             win.bias[b, slot], no_points, no_valid, ids[b],
                             feats.uv_rect[b], feats.ids[b], torch.zeros_like(feats.mask[b]),
                             zero))
        names = ("rot", "pos", "vel", "bias", "lmk_points", "lmk_valid", "lmk_ids", "kp_uv",
                 "kp_ids", "kp_mask", "n_recovered")
        return {k: torch.stack(col) for k, col in zip(names, zip(*rows))}

    @staticmethod
    def _switched_outputs(pipe: StereoImuPipeline, fe_outs: list, pim) -> dict:
        """A row's per-stream outputs that the JAX fleet's fused step adds
        under a switch, stacked: under `use_lcd` the keyframe branch's LCD
        features (`lcd_uv`, `lcd_ok`, `lcd_desc`, `lcd_versors`,
        `lcd_pts3`); under `do_fine_imu_camera_temporal_sync` the angle of
        the stereo rotation the time aligner is fed (`vis_rot_angle`);
        under `auto_initialize: 2` the online initializer's inputs, the
        stereo relative pose in the body frame (`init_R_rel_body`,
        `init_t_rel_body`) and the frame's preintegration (`pim`, stacked:
        `init_pim_delta_R`, `_delta_v`, `_delta_p`, `_dR_dbg`). A stream
        that does not keyframe gives what the JAX frontend's tracking
        branch gives: zero LCD features, an identity stereo rotation and a
        zero translation vote, through the same formulas."""
        cfg, dev = pipe.frontend_cfg, pipe.device
        kf = [fo["is_keyframe"] for fo in fe_outs]
        out = {}
        if cfg.lcd_features > 0:
            n = cfg.lcd_features
            zeros = {"lcd_uv": torch.zeros((n, 2), device=dev),
                     "lcd_ok": torch.zeros(n, dtype=torch.bool, device=dev),
                     "lcd_desc": torch.zeros((n, 8), dtype=torch.int32, device=dev),
                     "lcd_versors": torch.zeros((n, 3), device=dev),
                     "lcd_pts3": torch.zeros((n, 3), device=dev)}
            for k, z in zeros.items():
                out[k] = torch.stack([fo[k] if is_kf else z for fo, is_kf in zip(fe_outs, kf)])
        eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        if pipe._do_time_align:
            R = torch.stack([fo["R_stereo"] if is_kf else eye for fo, is_kf in zip(fe_outs, kf)])
            out["vis_rot_angle"] = torch.linalg.norm(so3_log(R), dim=-1)
        if pipe.params.backend.auto_initialize == 2:
            still = pipe._body_rel(eye, zero)
            rel = [fo["stereo_rel"][:2] if is_kf else still for fo, is_kf in zip(fe_outs, kf)]
            out.update(init_R_rel_body=torch.stack([R for R, _ in rel]),
                       init_t_rel_body=torch.stack([t for _, t in rel]),
                       init_pim_delta_R=pim.delta_R, init_pim_delta_v=pim.delta_v,
                       init_pim_delta_p=pim.delta_p, init_pim_dR_dbg=pim.dR_dbg)
        return out
