"""Core value types as dataclasses of torch tensors.

Port of kimera_vio_tpu/common/types.py. The JAX package keeps its state in
flax `struct` pytrees; here they are plain dataclasses whose fields are
tensors (or nested dataclasses), with the same fixed-capacity, masked
struct-of-arrays shapes so that a test can compare them field by field.

  * Timestamps are int64 nanoseconds on the host; on-device time is
    relative float32 seconds.
  * Per-feature containers are fixed-capacity SoA with a validity mask.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

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


@dataclass
class NavState:
    """World-frame navigation state: R_wb (3,3), p_wb (3,), v_w (3,)."""

    rot: torch.Tensor
    pos: torch.Tensor
    vel: torch.Tensor


@dataclass
class ImuBlock:
    """Fixed-capacity block of IMU samples between two camera frames;
    `dt` is the per-sample interval in seconds, 0 where masked."""

    acc: torch.Tensor  # (N, 3)
    gyr: torch.Tensor  # (N, 3)
    dt: torch.Tensor  # (N,)
    mask: torch.Tensor  # (N,) bool


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


@dataclass
class StereoMeasurements:
    """Per-keyframe stereo measurements [uL, uR, v] (rectified pixels) for
    the backend; uR is NaN for mono-only measurements."""

    ids: torch.Tensor  # (N,) int32
    uvs: torch.Tensor  # (N, 3)
    mask: torch.Tensor  # (N,) bool
