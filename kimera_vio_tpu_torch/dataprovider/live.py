"""Live (online) data provider: incremental push of sensor data, pull of
time-synced packets.

Port of kimera_vio_tpu/dataprovider/live.py. The reference's online input
path is a callback registry (`DataProviderInterface`) feeding a
`DataProviderModule` that time-syncs each frame against a
`ThreadsafeImuBuffer` with three FrameActions
(MonoDataProviderModule.cpp:46-121):

  * **Use**  — IMU covers (t_prev, t_frame]: emit a synced packet,
  * **Wait** — IMU not yet available up to t_frame: keep the frame queued
    (ThreadsafeImuBuffer QueryResult::kDataNotYetAvailable),
  * **Drop** — the frame predates the available IMU horizon or violates
    the monotonic-timestamp guard (kQueueShutdown/kDataNeverAvailable +
    the `timestamp_last_frame_` check).

A robot (or a replay thread) `push_*`es measurements from its sensor
threads; the pipeline pulls packets with `poll()` or iterates `frames()`.
Packets have the offline providers' schema (IMU blocks as CPU tensors),
so `StereoImuPipeline.run()` drives a live source unchanged; `replay()`
feeds an offline provider through this sync core. Memory stays bounded
on a long mission: an image is released when the pipeline loads it, and
the IMU buffer keeps `horizon_s` of samples. Also ported: live
`imu_time_shift_ns` updates from the fine time aligner
(DataProviderModule::setImuTimeShift) and the coarse IMU-camera clock
alignment on the first frame (DataProviderModule.cpp:110-120).

Two faults of the JAX file are repaired here (its tests name them):

  * after `stop()`, a queued frame that can never sync (no IMU past it,
    no right partner) made `frames()` wait forever (live.py:283-297);
    here such frames are dropped and counted, and `frames()` returns;
  * right frames had no monotonic-timestamp guard (live.py:172-180), so
    an out-of-order right frame could break the nearest-stamp pairing;
    here a right frame not newer than the last queued or paired one is
    dropped and counted in `dropped_right_frames`.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np

from kimera_vio_tpu_torch.dataprovider.euroc import ImuSynchronizer

#: a right frame pairs with the left frame nearest in time, within this
RIGHT_STAMP_TOLERANCE_NS = 5_000_000


class LiveImuBuffer:
    """Incremental IMU ring with the reference ThreadsafeImuBuffer's query
    semantics (utils/ThreadsafeImuBuffer.h:59-192): interpolated-upper-
    border blocks plus the QueryResult triage (available / not-yet /
    never). The samples live in numpy arrays; appends are O(1) amortized,
    storage is trimmed to `horizon_s` behind the newest sample, and a query
    reads only the samples bracketing its interval (two binary searches),
    so its cost does not grow with the horizon."""

    AVAILABLE = 0
    NOT_YET = 1  # newest IMU older than t1 -> caller should Wait
    NEVER = 2  # oldest IMU newer than t0 -> caller must Drop

    def __init__(self, max_per_block: int = 16, horizon_s: float = 60.0):
        self.max_per_block = max_per_block
        self.horizon_ns = int(horizon_s * 1e9)
        self._t = np.zeros(256, np.int64)
        self._acc = np.zeros((256, 3), np.float32)
        self._gyr = np.zeros((256, 3), np.float32)
        self._lo = self._end = 0  # the held samples are [_lo, _end)
        self._lock = threading.Lock()

    def push(self, stamp_ns: int, acc, gyr) -> bool:
        """Add one measurement. Out-of-order samples (stamp <= newest) are
        rejected, mirroring ThreadsafeImuBuffer's monotonicity contract
        (addMeasurement CHECK_GT; the reference crashes, this drops and
        returns False)."""
        with self._lock:
            if self._end > self._lo and stamp_ns <= self._t[self._end - 1]:
                return False
            if self._end == len(self._t):
                self._compact()
            i = self._end
            self._t[i] = stamp_ns
            self._acc[i] = acc
            self._gyr[i] = gyr
            self._end += 1
            # Trim beyond the horizon, keeping the last sample before it
            # (bounded RAM on long missions).
            cutoff = int(stamp_ns) - self.horizon_ns
            while self._end - self._lo > 2 and self._t[self._lo + 1] < cutoff:
                self._lo += 1
            return True

    def _compact(self):
        """Move the held samples to the front of new arrays, twice as long
        when they fill more than half of the old ones."""
        n = self._end - self._lo
        cap = 2 * len(self._t) if 2 * n > len(self._t) else len(self._t)
        for name in ("_t", "_acc", "_gyr"):
            old = getattr(self, name)
            new = np.zeros((cap,) + old.shape[1:], old.dtype)
            new[:n] = old[self._lo:self._end]
            setattr(self, name, new)
        self._lo, self._end = 0, n

    def newest_ns(self) -> int | None:
        """The newest sample's stamp, None while the buffer is empty."""
        with self._lock:
            return int(self._t[self._end - 1]) if self._end > self._lo else None

    @property
    def acc(self) -> np.ndarray:
        """Raw accel samples oldest-first (the bootstrap attitude reads the
        first ~50, the InitializationFromImu role)."""
        with self._lock:
            return self._acc[self._lo:self._end].copy()

    def query(self, t0_ns: int, t1_ns: int):
        """(status, ImuBlock | None) for the interval (t0, t1]."""
        with self._lock:
            t = self._t[self._lo:self._end]
            if not len(t) or t1_ns > t[-1]:
                return self.NOT_YET, None
            if t0_ns < t[0]:
                return self.NEVER, None
            # The block needs the samples in (t0, t1] and one on each side:
            # the last at or before t0 and the first after t1.
            a = self._lo + int(np.searchsorted(t, t0_ns, side="right")) - 1
            b = self._lo + int(np.searchsorted(t, t1_ns, side="right")) + 1
            b = min(b, self._end)
            sync = ImuSynchronizer(self._t[a:b], self._acc[a:b], self._gyr[a:b],
                                   max_per_block=self.max_per_block)
        blk = sync.block(t0_ns, t1_ns)
        return (self.AVAILABLE, blk) if blk is not None else (self.NEVER, None)


class LiveDataProvider:
    """Push-in / pull-out provider with the reference's online sync
    semantics. The pipeline-facing surface matches the offline providers:
    a `frames()` generator, `load_image(key)`, `ground_truth` (None unless
    the caller attaches one), `imu_sync` (the live buffer), a writable
    `imu_time_shift_ns`."""

    def __init__(
        self,
        stereo: bool = True,
        max_per_block: int = 16,
        max_queued_frames: int = 10,
        do_coarse_imu_camera_temporal_sync: bool = False,
    ):
        self.stereo = stereo
        self.imu_sync = LiveImuBuffer(max_per_block=max_per_block)
        self.ground_truth = None
        self.imu_time_shift_ns = 0  # updated live by the fine time aligner
        self.imu_timestamp_correction_ns = 0
        self._do_coarse_sync = do_coarse_imu_camera_temporal_sync
        self._left: deque = deque()  # (stamp_ns, key)
        self._right: deque = deque()
        self._images: dict = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._max_queued = max_queued_frames
        self._last_emitted_ns = -(2**62)
        self._last_right_ns = -(2**62)  # newest right stamp queued or paired
        self._prev_t = None  # previous emitted frame's shifted stamp
        self._index = 0
        self._stopped = False
        self.dropped_frames = 0
        self.dropped_right_frames = 0
        self.dropped_imu = 0

    # -- sensor side (the reference's registered callbacks) ---------------
    def push_imu(self, stamp_ns: int, acc, gyr):
        """registerImuSingleCallback role."""
        if not self.imu_sync.push(stamp_ns, acc, gyr):
            self.dropped_imu += 1
        else:
            with self._cv:
                self._cv.notify_all()

    def push_left_frame(self, stamp_ns: int, image: np.ndarray):
        """registerLeftFrameCallback role. Monotonicity is enforced here
        (MonoDataProviderModule.cpp: 'Dropping frame: older than the last
        processed'); overflow beyond max_queued_frames drops the OLDEST
        queued frame (bounded latency, like the bounded frontend queue)."""
        with self._cv:
            if stamp_ns <= self._last_emitted_ns or (self._left and stamp_ns <= self._left[-1][0]):
                self.dropped_frames += 1
                return
            key = f"live://left/{int(stamp_ns)}"
            self._images[key] = image
            self._left.append((int(stamp_ns), key))
            while len(self._left) > self._max_queued:
                _, old_key = self._left.popleft()
                self._images.pop(old_key, None)
                self.dropped_frames += 1
            self._cv.notify_all()

    def push_right_frame(self, stamp_ns: int, image: np.ndarray):
        """registerRightFrameCallback role, with the left side's
        monotonic-timestamp guard (a repair of the JAX file)."""
        with self._cv:
            if stamp_ns <= self._last_right_ns:
                self.dropped_right_frames += 1
                return
            self._last_right_ns = int(stamp_ns)
            key = f"live://right/{int(stamp_ns)}"
            self._images[key] = image
            self._right.append((int(stamp_ns), key))
            while len(self._right) > self._max_queued:
                _, old_key = self._right.popleft()
                self._images.pop(old_key, None)
            self._cv.notify_all()

    def stop(self):
        """End of mission: `frames()` emits what can still sync, drops the
        rest and returns."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    # -- pipeline side -----------------------------------------------------
    def load_image(self, key: str) -> np.ndarray:
        """An emitted frame's image. A live image is read once: it is
        released here, so the provider holds only the frames not yet
        consumed."""
        with self._lock:
            img = self._images.pop(key, None)
        if img is None:
            raise KeyError(f"live image already consumed: {key}")
        return img

    def poll(self):
        """One sync attempt (non-blocking): returns a packet dict, or None
        when nothing can be emitted yet (Wait), dropping stale frames as a
        side effect (Drop). Mirrors getTimeSyncedImuMeasurements."""
        with self._lock:
            return self._poll_locked()

    def _drop_left(self):
        _, key = self._left.popleft()
        self._images.pop(key, None)
        self.dropped_frames += 1

    def _poll_locked(self):
        while self._left:
            stamp_ns, key = self._left[0]
            if self.stereo:
                # Pair the right frame by nearest timestamp within
                # tolerance (StereoDataProviderModule left/right sync).
                while (len(self._right) > 1
                       and abs(self._right[1][0] - stamp_ns) <= abs(self._right[0][0] - stamp_ns)):
                    _, k_old = self._right.popleft()
                    self._images.pop(k_old, None)
                if not self._right:
                    return None  # Wait for the right frame
                r_stamp, _ = self._right[0]
                if r_stamp - stamp_ns > RIGHT_STAMP_TOLERANCE_NS:
                    # Right stream has moved past this left frame: Drop.
                    self._drop_left()
                    continue
                if abs(r_stamp - stamp_ns) > RIGHT_STAMP_TOLERANCE_NS:
                    return None  # Wait for a matching right frame
            if self._do_coarse_sync:
                # Coarse clock alignment on the first frame
                # (DataProviderModule.cpp:110-120): correction = newest
                # IMU stamp minus frame stamp.
                newest = self.imu_sync.newest_ns()
                if newest is None:
                    return None
                self.imu_timestamp_correction_ns = newest - int(stamp_ns)
                self._do_coarse_sync = False
            t = int(stamp_ns) + self.imu_time_shift_ns + self.imu_timestamp_correction_ns
            packet = {"index": self._index, "stamp_ns": int(stamp_ns), "left_path": key}
            if self.stereo:
                packet["right_path"] = self._right[0][1]
            if self._prev_t is None:
                # First frame: packet without preintegration, but only
                # once IMU exists at/before t (the backend bootstraps
                # attitude from it) — else Wait.
                status, _ = self.imu_sync.query(t - 1, t)
                if status == LiveImuBuffer.NOT_YET:
                    return None
                packet["imu"] = None
            else:
                status, blk = self.imu_sync.query(self._prev_t, t)
                if status == LiveImuBuffer.NOT_YET:
                    return None  # Wait: IMU will arrive
                if status == LiveImuBuffer.NEVER:
                    # Frame predates the IMU horizon: Drop it.
                    self._drop_left()
                    if self.stereo and self._right:
                        _, rk = self._right.popleft()
                        self._images.pop(rk, None)
                    continue
                packet["imu"] = blk
            self._left.popleft()
            if self.stereo:
                self._right.popleft()
            self._prev_t = t
            self._last_emitted_ns = int(stamp_ns)
            self._index += 1
            return packet
        return None

    def frames(self, timeout_s: float = 1.0):
        """Blocking generator over synced packets until `stop()` — the
        surface `StereoImuPipeline.run()` consumes, so a live source
        drives the pipeline exactly like a dataset replay. Once stopped, a
        frame that still waits can never sync: it is dropped."""
        while True:
            with self._cv:
                packet = self._poll_locked()
                if packet is None:
                    if self._stopped:
                        while self._left:
                            self._drop_left()
                        return
                    self._cv.wait(timeout=timeout_s)
                    continue
            yield packet


def replay(offline_provider, live: LiveDataProvider):
    """Feed an offline provider's data through a LiveDataProvider in
    timestamp order (the reference's EurocDataProvider::spin sends all IMU
    first, then frames, EurocDataProvider.cpp:109-128 — here interleaved
    like a real sensor: each frame after the IMU up to its stamp), then
    stop it."""
    sync = offline_provider.imu_sync
    imu_i = 0
    n_imu = len(sync.t)
    for packet in offline_provider.frames():
        while imu_i < n_imu and sync.t[imu_i] <= packet["stamp_ns"]:
            live.push_imu(int(sync.t[imu_i]), sync.acc[imu_i], sync.gyr[imu_i])
            imu_i += 1
        left = offline_provider.load_image(packet["left_path"])
        if "right_path" in packet:
            live.push_right_frame(packet["stamp_ns"], offline_provider.load_image(packet["right_path"]))
        live.push_left_frame(packet["stamp_ns"], left)
    while imu_i < n_imu:
        live.push_imu(int(sync.t[imu_i]), sync.acc[imu_i], sync.gyr[imu_i])
        imu_i += 1
    live.stop()
