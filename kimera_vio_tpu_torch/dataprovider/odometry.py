"""External odometry buffer (wheel / LiDAR / leg odometry input).

Port of kimera_vio_tpu/dataprovider/odometry.py (the reference's
ThreadsafeOdometryBuffer, src/utils/ThreadsafeOdometryBuffer.cpp): a
timestamp-indexed store of external poses with nearest-neighbour lookup.
A provider that carries one as `.odometry` makes `run()` attach each
keyframe's nearest pose to the backend, which turns it into a
keyframe-relative between factor (VioBackend.cpp:402-420). Host numpy
only.
"""

from __future__ import annotations

import numpy as np


class OdometryBuffer:
    def __init__(self, max_size: int = 100000):
        self._stamps: list[int] = []
        self._R: list[np.ndarray] = []
        self._t: list[np.ndarray] = []
        self._vel: list[np.ndarray] = []
        self.max_size = max_size

    def add(self, stamp_ns: int, R_world_body, t_world_body, vel_world=None):
        self._stamps.append(int(stamp_ns))
        self._R.append(np.asarray(R_world_body, np.float64))
        self._t.append(np.asarray(t_world_body, np.float64))
        self._vel.append(np.asarray(vel_world, np.float64) if vel_world is not None
                         else np.zeros(3))
        if len(self._stamps) > self.max_size:
            for buf in (self._stamps, self._R, self._t, self._vel):
                buf.pop(0)

    def get_nearest(self, stamp_ns: int, tolerance_ns: int | None = None):
        """The nearest stored state, or None when the buffer is empty or
        the nearest one lies outside the tolerance (getNearest)."""
        if not self._stamps:
            return None
        stamps = np.asarray(self._stamps)
        i = int(np.argmin(np.abs(stamps - stamp_ns)))
        if tolerance_ns is not None and abs(int(stamps[i]) - stamp_ns) > tolerance_ns:
            return None
        return {"stamp_ns": int(stamps[i]), "R": self._R[i], "t": self._t[i], "vel": self._vel[i]}

    def relative(self, stamp_a_ns: int, stamp_b_ns: int, tolerance_ns=None):
        """Relative pose a -> b of the nearest stored states, (R_ab, t_ab)
        with x_a = R_ab x_b + t_ab; None if either is missing or both are
        the same state."""
        a = self.get_nearest(stamp_a_ns, tolerance_ns)
        b = self.get_nearest(stamp_b_ns, tolerance_ns)
        if a is None or b is None or a["stamp_ns"] == b["stamp_ns"]:
            return None
        return a["R"].T @ b["R"], a["R"].T @ (b["t"] - a["t"])

    def __len__(self):
        return len(self._stamps)
