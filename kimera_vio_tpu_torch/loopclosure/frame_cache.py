"""Disk-backed LRU archive of LCD keyframe data.

The port's copy of kimera_vio_tpu/loopclosure/frame_cache.py (numpy
only). Rebuild of the reference FrameCache (src/loopclosure/FrameCache.cpp:1-368):
bounds the RAM held by the loop-closure database on long missions by
spilling the per-keyframe payloads (descriptors, keypoints, 3D points) to
disk, keeping a fixed-size in-memory LRU window. Serialization is plain
``np.savez`` instead of the reference's hand-rolled binary format.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np


class FrameCache:
    def __init__(self, cache_dir: str | None = None, max_in_memory: int = 100):
        self.max_in_memory = max_in_memory
        self.dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        self._mem: OrderedDict[int, dict] = OrderedDict()
        self._on_disk: set[int] = set()
        self.n_frames = 0

    def _path(self, kf_id: int) -> str:
        return os.path.join(self.dir, f"lcd_frame_{kf_id:06d}.npz")

    def add(self, kf_id: int, payload: dict):
        """payload: dict of numpy arrays (desc, mask, uv, versors, pts3d)."""
        self._mem[kf_id] = payload
        self._mem.move_to_end(kf_id)
        self.n_frames = max(self.n_frames, kf_id + 1)
        while len(self._mem) > self.max_in_memory:
            old_id, old = self._mem.popitem(last=False)
            if self.dir is not None:
                np.savez(self._path(old_id), **old)
                self._on_disk.add(old_id)
            # Without a cache dir the payload is simply dropped (the
            # reference requires a path; we degrade gracefully).

    def get(self, kf_id: int) -> dict | None:
        if kf_id in self._mem:
            self._mem.move_to_end(kf_id)
            return self._mem[kf_id]
        if kf_id in self._on_disk:
            data = dict(np.load(self._path(kf_id)))
            self.add(kf_id, data)
            return data
        return None

    def __contains__(self, kf_id: int) -> bool:
        return kf_id in self._mem or kf_id in self._on_disk

    def __len__(self):
        return self.n_frames
