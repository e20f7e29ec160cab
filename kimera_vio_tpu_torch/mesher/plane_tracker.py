"""Plane identity across keyframes (reference Mesher::associatePlanes,
src/mesh/Mesher.cpp:1316-1420).

The port's own copy of kimera_vio_tpu/mesher/plane_tracker.py (numpy
only). The persistent planes live in the fixed slots of the P-slot
`PlaneStates` that the RegularVIO solve takes, so association is host
bookkeeping and the solve keeps its shapes. A keyframe's segmented planes
are associated with the active slots by geometric proximity (normals
within a tolerance, or antiparallel with the distance's sign flipped, and
distances within a tolerance): an associated plane keeps its slot and
identity, an unassociated one claims a free slot. After each joint solve
the refined normals and distances are written back (`update_from_solver`).
"""

from __future__ import annotations

import numpy as np


class PlaneTracker:
    def __init__(self, max_planes: int = 8, normal_tol_deg: float = 10.0,
                 dist_tol: float = 0.20, max_age_kf: int = 10):
        self.P = max_planes
        self.cos_tol = float(np.cos(np.deg2rad(normal_tol_deg)))
        self.dist_tol = dist_tol
        self.max_age_kf = max_age_kf
        self.normals = np.zeros((max_planes, 3), np.float32)
        self.normals[:, 2] = 1.0
        self.ds = np.zeros(max_planes, np.float32)
        self.active = np.zeros(max_planes, bool)
        self.last_seen = np.full(max_planes, -1, np.int64)
        self.hits = np.zeros(max_planes, np.int64)
        # Slot -> persistent plane id; a reused slot gets a fresh id.
        self.slot_pid = np.full(max_planes, -1, np.int64)
        self._next_pid = 0
        self._kf_index = 0

    def associate(self, seg_normals, seg_ds):
        """One keyframe's segmented planes -> persistent slots. Returns
        (slot_of_seg (S,) int32, -1 where no slot was free; seen (P,))."""
        k = self._kf_index
        self._kf_index += 1
        seg_normals = np.asarray(seg_normals, np.float32)
        seg_ds = np.asarray(seg_ds, np.float32)
        S = len(seg_ds)
        slot_of_seg = np.full(S, -1, np.int32)
        seen = np.zeros(self.P, bool)
        # Age out planes not seen for max_age_kf keyframes first.
        self.active &= ~(self.active & (k - self.last_seen > self.max_age_kf))
        claimed: set[int] = set()
        for s in range(S):
            n, d = seg_normals[s], seg_ds[s]
            best, best_dot = -1, self.cos_tol
            for p in range(self.P):
                if not self.active[p] or p in claimed:
                    continue
                dot = float(n @ self.normals[p])
                dd = d - self.ds[p]
                if dot < 0:  # antiparallel: the same plane, flipped normal
                    dot, dd = -dot, d + self.ds[p]
                if dot >= best_dot and abs(dd) <= self.dist_tol:
                    best, best_dot = p, dot
            if best < 0:
                free = np.flatnonzero(~self.active)
                if len(free) == 0:
                    continue  # table full: drop this segmentation
                best = int(free[0])
                self.normals[best] = n
                self.ds[best] = d
                self.active[best] = True
                self.hits[best] = 0
                self.slot_pid[best] = self._next_pid
                self._next_pid += 1
            claimed.add(best)
            slot_of_seg[s] = best
            seen[best] = True
            self.last_seen[best] = k
            self.hits[best] += 1
        return slot_of_seg, seen

    def update_from_solver(self, normals, ds):
        """Write the solver's refined states back into the active slots."""
        normals = np.asarray(normals, np.float32)
        ds = np.asarray(ds, np.float32)
        self.normals[self.active] = normals[self.active]
        self.ds[self.active] = ds[self.active]

    def parallel_pairs(self, angle_deg: float = 10.0, min_hits: int = 2) -> list:
        """Distinct active planes seen at least `min_hits` times whose
        normals are parallel or antiparallel within `angle_deg`: the pairs
        of the parallel-plane regularity."""
        cos_tol = np.cos(np.deg2rad(angle_deg))
        act = np.flatnonzero(self.active & (self.hits >= min_hits))
        return [(int(act[a]), int(act[b])) for a in range(len(act)) for b in range(a + 1, len(act))
                if abs(float(self.normals[act[a]] @ self.normals[act[b]])) >= cos_tol]
