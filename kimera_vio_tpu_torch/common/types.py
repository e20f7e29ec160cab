"""Core value types as dataclasses of torch tensors.

Port of kimera_vio_tpu/common/types.py. The JAX package keeps its state in
flax `struct` pytrees; here they are plain dataclasses whose fields are
tensors (or nested dataclasses), with the same fixed-capacity, masked
struct-of-arrays shapes so that a test can compare them field by field.

  * Timestamps are int64 nanoseconds on the host; on-device time is
    relative float32 seconds.
  * Per-feature containers are fixed-capacity SoA with a validity mask.
  * A stacked tree (`stack_trees`) carries B streams: a leading stream
    axis on every tensor and one numpy array per host scalar;
    `unstack_trees` splits it into its streams, `tree_set` writes one
    stream of it and `tree_clone` copies it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from kimera_vio_tpu_torch import resolve_device


def replace(obj, **changes):
    """Functional update of a dataclass (flax `.replace` counterpart)."""
    return dataclasses.replace(obj, **changes)


def tree_map(fn, obj):
    """Apply `fn` to every tensor leaf of a (nested) dataclass, tuple or
    list; other leaves pass through unchanged."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(
            obj,
            **{f.name: tree_map(fn, getattr(obj, f.name)) for f in dataclasses.fields(obj)},
        )
    if isinstance(obj, (tuple, list)):
        return type(obj)(tree_map(fn, x) for x in obj)
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    return obj


def tree_map2(fn, a, b):
    """`tree_map` over two structurally equal trees."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return dataclasses.replace(
            a,
            **{
                f.name: tree_map2(fn, getattr(a, f.name), getattr(b, f.name))
                for f in dataclasses.fields(a)
            },
        )
    if isinstance(a, (tuple, list)):
        return type(a)(tree_map2(fn, x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return fn(a, b)
    return a


def stack_trees(trees: list):
    """Structurally equal trees (dataclasses, tuples, lists, dicts) -> one
    tree with a leading stream axis: tensor leaves are stacked on dim 0,
    host scalars (int, float, bool) become numpy arrays of one value per
    stream, None stays None (the LK template cache's skipped levels)."""
    first = trees[0]
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(
            first,
            **{f.name: stack_trees([getattr(t, f.name) for t in trees])
               for f in dataclasses.fields(first)},
        )
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(stack_trees(list(xs)) for xs in zip(*trees))
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if first is None:
        return None
    return np.array(trees)


def unstack_trees(tree, n: int) -> list:
    """The n single-stream trees of a stacked tree (`stack_trees`'s
    inverse; dicts too): tensor leaves as views, numpy leaves as their
    rows (Python scalars where a row has no axis)."""
    def rows(cols):
        return list(zip(*cols)) if cols else [()] * n

    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        cols = [unstack_trees(getattr(tree, k), n) for k in names]
        return [dataclasses.replace(tree, **dict(zip(names, row))) for row in rows(cols)]
    if isinstance(tree, dict):
        return [dict(zip(tree, row)) for row in rows([unstack_trees(v, n) for v in tree.values()])]
    if isinstance(tree, (tuple, list)):
        return [type(tree)(row) for row in rows([unstack_trees(x, n) for x in tree])]
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    if isinstance(tree, np.ndarray):
        return [x.item() if x.ndim == 0 else x for x in tree]
    return [tree] * n


def tree_clone(tree):
    """A copy of a tree that shares no tensor or numpy array with it."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: tree_clone(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
        )
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_clone(x) for x in tree)
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


def tree_set(dst, b: int, src) -> None:
    """Write the single-stream tree `src` into stream b of the stacked
    tree `dst`, in place (tensor slices copied, host values assigned)."""
    if dataclasses.is_dataclass(dst) and not isinstance(dst, type):
        for f in dataclasses.fields(dst):
            tree_set(getattr(dst, f.name), b, getattr(src, f.name))
    elif isinstance(dst, dict):
        for k, d in dst.items():
            tree_set(d, b, src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            tree_set(d, b, s)
    elif isinstance(dst, torch.Tensor):
        dst[b].copy_(src)
    elif isinstance(dst, np.ndarray):
        dst[b] = src


@dataclass
class ImuBias:
    """Accelerometer + gyroscope bias."""

    accel: torch.Tensor  # (3,)
    gyro: torch.Tensor  # (3,)

    @classmethod
    def zero(cls, device="cuda", dtype=torch.float32) -> "ImuBias":
        device = resolve_device(device)
        return cls(
            accel=torch.zeros(3, dtype=dtype, device=device),
            gyro=torch.zeros(3, dtype=dtype, device=device),
        )

    def as_vector(self) -> torch.Tensor:
        """[accel, gyro] (...,6)."""
        return torch.cat([self.accel, self.gyro], dim=-1)


@dataclass
class NavState:
    """World-frame navigation state: R_wb (3,3), p_wb (3,), v_w (3,)."""

    rot: torch.Tensor
    pos: torch.Tensor
    vel: torch.Tensor

    @classmethod
    def identity(cls, device="cuda", dtype=torch.float32) -> "NavState":
        device = resolve_device(device)
        return cls(
            rot=torch.eye(3, dtype=dtype, device=device),
            pos=torch.zeros(3, dtype=dtype, device=device),
            vel=torch.zeros(3, dtype=dtype, device=device),
        )


@dataclass
class VioNavState:
    """NavState + IMU bias, the full per-keyframe estimator state
    (reference common/VioNavState.h)."""

    nav: NavState
    bias: ImuBias

    @classmethod
    def identity(cls, device="cuda", dtype=torch.float32) -> "VioNavState":
        return cls(nav=NavState.identity(device, dtype), bias=ImuBias.zero(device, dtype))


@dataclass
class ImuBlock:
    """Fixed-capacity block of IMU samples between two camera frames;
    `dt` is the per-sample interval in seconds, 0 where masked."""

    acc: torch.Tensor  # (N, 3)
    gyr: torch.Tensor  # (N, 3)
    dt: torch.Tensor  # (N,)
    mask: torch.Tensor  # (N,) bool

    @property
    def capacity(self) -> int:
        return self.acc.shape[-2]


@dataclass
class TrackedFeatures:
    """Fixed-capacity feature-track slots for one camera: `uv` distorted
    pixels (tracker domain), `uv_rect` rectified pixels, `versors` unit
    bearings, `ids` landmark ids (-1 = empty), `ages` keyframes observed."""

    uv: torch.Tensor  # (N, 2)
    uv_rect: torch.Tensor  # (N, 2)
    versors: torch.Tensor  # (N, 3)
    ids: torch.Tensor  # (N,) int32
    ages: torch.Tensor  # (N,) int32
    mask: torch.Tensor  # (N,) bool

    @classmethod
    def empty(cls, capacity: int, device="cuda", dtype=torch.float32) -> "TrackedFeatures":
        device = resolve_device(device)
        return cls(
            uv=torch.zeros((capacity, 2), dtype=dtype, device=device),
            uv_rect=torch.zeros((capacity, 2), dtype=dtype, device=device),
            versors=torch.zeros((capacity, 3), dtype=dtype, device=device),
            ids=torch.full((capacity,), -1, dtype=torch.int32, device=device),
            ages=torch.zeros((capacity,), dtype=torch.int32, device=device),
            mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.ids.shape[-1]


@dataclass
class StereoMeasurements:
    """Per-keyframe stereo measurements [uL, uR, v] (rectified pixels) for
    the backend; uR is NaN for mono-only measurements."""

    ids: torch.Tensor  # (N,) int32
    uvs: torch.Tensor  # (N, 3)
    mask: torch.Tensor  # (N,) bool
