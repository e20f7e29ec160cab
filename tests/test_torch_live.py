"""The port's live (online) provider against the JAX package's.

  * Twins of tests/test_live_provider.py:29-132: the IMU buffer's query
    triage and out-of-order rejection, and the provider's Use / Wait /
    Drop actions, monotonic guard, stereo pairing, queue bound and live
    `imu_time_shift_ns`. Each scenario runs on both packages with the JAX
    test's assertions; what each poll returns (None, or the packet's
    index, stamp, paths and IMU block) and the drop counters are equal,
    IMU blocks exactly.
  * The two faults of the JAX file that the port repairs, port only:
    `frames()` returns after `stop()` although a queued frame can never
    sync (JAX live.py:283-297 waits forever), and right frames get the
    left side's monotonic-timestamp guard (JAX live.py:172-180 queues an
    out-of-order right frame, which can then evict the right partner of a
    later left frame).
  * The port-only counterpart of tests/test_live_provider.py:148, which
    never passed in the JAX package (its live side bootstraps from the
    IMU attitude at zero velocity while its offline side starts from the
    ground truth): the 160x120 synthetic sequence replayed through
    `LiveDataProvider` on a feeder thread into `run()`, against the
    offline `run()`, with the same bootstrap on both sides (the ground
    truth attached to the live provider): the same frames and keyframe
    stamps, positions within 1e-6 m.
"""

import threading
import time

import numpy as np
import pytest
import torch

from kimera_vio_tpu.dataprovider import live as jlive
from kimera_vio_tpu_torch.dataprovider import live as tlive
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider, synthetic_params
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline

MS = 1_000_000  # ns per ms


def img(v=0):
    return np.full((24, 32), v, np.uint8)


def feed_imu(p, t0_ms, t1_ms, step_ms=5):
    for t in range(t0_ms, t1_ms, step_ms):
        p.push_imu(t * MS, (0.0, 0.0, 9.81), (0.0, 0.0, 0.0))


def _summary(pk):
    """What a poll returned, with the IMU block as numpy."""
    if pk is None:
        return None
    out = {k: v for k, v in pk.items() if k != "imu"}
    if pk["imu"] is not None:
        out["imu"] = {f: np.asarray(getattr(pk["imu"], f)) for f in ("acc", "gyr", "dt", "mask")}
    return out


def _assert_same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    else:
        assert a == b


def _twin(scenario):
    """Run `scenario(module)` on the JAX and the port's live module; their
    traces must be equal. Returns the port's trace."""
    want = scenario(jlive)
    got = scenario(tlive)
    _assert_same(want, got)
    return got


class TestLiveImuBuffer:
    def test_query_triage(self):
        def scenario(mod):
            B = mod.LiveImuBuffer
            buf = B()
            trace = [buf.query(0, 10 * MS)[0]]
            assert trace[0] == B.NOT_YET
            for t in range(0, 100, 5):
                assert buf.push(t * MS, (0, 0, 9.81), (0, 0, 0))
            st, blk = buf.query(10 * MS, 42 * MS)
            assert st == B.AVAILABLE
            n = int(np.asarray(blk.mask).sum())
            assert n == 7  # samples at 15..40 (6) + interpolated at 42
            assert abs(float(np.asarray(blk.dt)[:n].sum()) - 0.032) < 1e-6
            trace += [st, {f: np.asarray(getattr(blk, f)) for f in ("acc", "gyr", "dt", "mask")}]
            trace.append(buf.query(50 * MS, 200 * MS)[0])
            assert trace[-1] == B.NOT_YET  # past the newest: Wait
            trace.append(buf.query(-10 * MS, 20 * MS)[0])
            assert trace[-1] == B.NEVER  # before the oldest: Drop
            trace.append(np.asarray(buf.acc))
            return trace

        _twin(scenario)

    def test_long_stream_past_the_horizon(self):
        """Five seconds at 200 Hz into a 0.5 s horizon: every query over
        the stream gives the JAX buffer's status and block, exactly."""
        def scenario(mod):
            buf = mod.LiveImuBuffer(horizon_s=0.5)
            rng = np.random.default_rng(3)
            trace = []
            for k in range(1000):
                buf.push(k * 5 * MS, rng.normal(size=3), rng.normal(size=3))
                if k % 37 == 36:
                    t1 = k * 5 * MS - int(rng.integers(0, 30)) * MS
                    for t0 in (t1 - 50 * MS, t1 - 400 * MS, t1 - 700 * MS):
                        st, blk = buf.query(t0, t1)
                        trace.append(st)
                        if blk is not None:
                            trace.append({f: np.asarray(getattr(blk, f))
                                          for f in ("acc", "gyr", "dt", "mask")})
            trace.append(np.asarray(buf.acc))
            return trace

        statuses = [x for x in _twin(scenario) if isinstance(x, int)]
        assert statuses.count(tlive.LiveImuBuffer.AVAILABLE) >= 40
        assert statuses.count(tlive.LiveImuBuffer.NEVER) >= 20

    def test_out_of_order_imu_rejected(self):
        def scenario(mod):
            buf = mod.LiveImuBuffer()
            trace = [buf.push(10 * MS, (0, 0, 9.81), (0, 0, 0)),
                     buf.push(5 * MS, (0, 0, 9.81), (0, 0, 0)),
                     buf.push(10 * MS, (0, 0, 9.81), (0, 0, 0)),
                     buf.push(15 * MS, (0, 0, 9.81), (0, 0, 0))]
            assert trace == [True, False, False, True]
            return trace

        _twin(scenario)


class TestLiveProviderSync:
    def test_basic_use(self):
        """IMU leading frames: every frame emits a packet with an IMU block
        spanning exactly the inter-frame interval."""
        def scenario(mod):
            p = mod.LiveDataProvider(stereo=True)
            feed_imu(p, 0, 200)
            for t in (50, 100, 150):
                p.push_right_frame(t * MS, img())
                p.push_left_frame(t * MS, img())
            pks = [p.poll() for _ in range(4)]
            assert pks[0] is not None and pks[0]["imu"] is None  # first frame
            assert pks[1] is not None and pks[1]["stamp_ns"] == 100 * MS
            n = int(np.asarray(pks[1]["imu"].mask).sum())
            assert abs(np.asarray(pks[1]["imu"].dt)[:n].sum() - 0.050) < 1e-6
            assert pks[2] is not None
            assert pks[3] is None  # queue drained
            return [_summary(pk) for pk in pks]

        _twin(scenario)

    def test_image_before_imu_waits(self):
        """A frame before the IMU covers it waits (ImageBeforeImuTest)."""
        def scenario(mod):
            p = mod.LiveDataProvider(stereo=False)
            p.push_left_frame(100 * MS, img())
            trace = [p.poll()]  # no IMU at all yet
            feed_imu(p, 0, 90)
            trace.append(p.poll())  # IMU not yet past the frame stamp
            feed_imu(p, 90, 120)
            trace.append(p.poll())
            assert trace[0] is None and trace[1] is None
            assert trace[2] is not None and trace[2]["stamp_ns"] == 100 * MS
            return [_summary(pk) for pk in trace]

        _twin(scenario)

    def test_frame_older_than_imu_horizon_dropped(self):
        def scenario(mod):
            p = mod.LiveDataProvider(stereo=False)
            feed_imu(p, 100, 300)
            p.push_left_frame(110 * MS, img())
            trace = [p.poll()]
            assert trace[0] is not None
            p.push_left_frame(105 * MS, img())  # backwards stamp: the guard drops it
            trace.append(p.poll())
            assert trace[1] is None and p.dropped_frames == 1
            p.push_left_frame(200 * MS, img())
            trace.append(p.poll())
            assert trace[2] is not None and trace[2]["stamp_ns"] == 200 * MS
            return [_summary(pk) for pk in trace] + [p.dropped_frames]

        _twin(scenario)

    def test_monotonic_guard_drops_stale_frames(self):
        def scenario(mod):
            p = mod.LiveDataProvider(stereo=False)
            feed_imu(p, 0, 300)
            p.push_left_frame(100 * MS, img())
            trace = [p.poll()]
            assert trace[0] is not None
            p.push_left_frame(100 * MS, img())  # duplicate stamp
            p.push_left_frame(90 * MS, img())  # older
            trace.append(p.poll())
            assert trace[1] is None and p.dropped_frames == 2
            return [_summary(pk) for pk in trace] + [p.dropped_frames]

        _twin(scenario)

    def test_stereo_right_frame_wait_and_pairing(self):
        """Left waits for its right partner; stale rights are discarded."""
        def scenario(mod):
            p = mod.LiveDataProvider(stereo=True)
            feed_imu(p, 0, 300)
            p.push_right_frame(40 * MS, img(1))  # stale right (no left pair)
            p.push_left_frame(100 * MS, img())
            trace = [p.poll()]  # Wait: no right frame within tolerance
            p.push_right_frame(100 * MS, img(2))
            trace.append(p.poll())
            assert trace[0] is None and trace[1] is not None
            assert np.all(p.load_image(trace[1]["right_path"]) == 2)
            return [_summary(pk) for pk in trace]

        _twin(scenario)

    def test_queue_bound_drops_oldest(self):
        def scenario(mod):
            p = mod.LiveDataProvider(stereo=False, max_queued_frames=3)
            for t in range(100, 100 + 10 * 50, 50):  # no IMU: frames accumulate
                p.push_left_frame(t * MS, img())
            assert len(p._left) == 3
            assert p.dropped_frames == 7
            return [list(p._left), p.dropped_frames]

        _twin(scenario)

    def test_coarse_imu_camera_sync(self):
        """The IMU clock 1 s ahead of the camera's: on the first frame the
        correction is the newest IMU stamp minus the frame's
        (DataProviderModule.cpp:110-120), and later frames' IMU blocks
        span their intervals on the IMU's clock."""
        def scenario(mod):
            p = mod.LiveDataProvider(stereo=False, do_coarse_imu_camera_temporal_sync=True)
            p.push_left_frame(100 * MS, img())
            trace = [p.poll()]  # Wait: no IMU yet
            feed_imu(p, 1000, 1105)
            trace.append(p.poll())
            trace.append(p.imu_timestamp_correction_ns)
            feed_imu(p, 1105, 1300)
            for t in (150, 200):
                p.push_left_frame(t * MS, img())
            trace += [p.poll(), p.poll(), p.poll()]
            assert trace[0] is None and trace[1]["stamp_ns"] == 100 * MS
            assert trace[2] == 1000 * MS
            for pk in trace[3:5]:
                n = int(np.asarray(pk["imu"].mask).sum())
                assert abs(np.asarray(pk["imu"].dt)[:n].sum() - 0.050) < 1e-6
            assert trace[5] is None
            return [x if isinstance(x, int) else _summary(x) for x in trace]

        _twin(scenario)

    def test_live_time_shift_update(self):
        """imu_time_shift_ns updates apply to later packets
        (DataProviderModule::setImuTimeShift)."""
        def scenario(mod):
            p = mod.LiveDataProvider(stereo=False)
            feed_imu(p, 0, 400)
            p.push_left_frame(100 * MS, img())
            trace = [p.poll()]
            p.imu_time_shift_ns = 20 * MS
            p.push_left_frame(200 * MS, img())
            trace.append(p.poll())
            n = int(np.asarray(trace[1]["imu"].mask).sum())
            # The interval is (100, 220] in IMU time: 0.120 s.
            assert abs(np.asarray(trace[1]["imu"].dt)[:n].sum() - 0.120) < 1e-6
            return [_summary(pk) for pk in trace]

        _twin(scenario)


# ---------------------------------------------------------------------------
# Repaired faults of the JAX file (port only)
# ---------------------------------------------------------------------------


def _drain_in_thread(p):
    got = []
    th = threading.Thread(target=lambda: got.extend(p.frames(timeout_s=0.05)), daemon=True)
    th.start()
    return th, got


@pytest.mark.parametrize("case", ["no_imu_past_frame", "no_right_frame"])
def test_frames_returns_after_stop(case):
    """Divergence from JAX live.py:283-297: after stop(), a queued frame
    that can never sync is dropped and counted and frames() returns (the
    JAX generator keeps waiting for it)."""
    p = tlive.LiveDataProvider(stereo=case == "no_right_frame")
    feed_imu(p, 0, 120 if case == "no_imu_past_frame" else 300)
    for t in (50, 100):
        if case == "no_right_frame":
            p.push_right_frame(t * MS, img())
        p.push_left_frame(t * MS, img())
    p.push_left_frame(200 * MS, img())  # IMU ends at 115 ms / no right frame at 200 ms
    th, got = _drain_in_thread(p)
    deadline = time.monotonic() + 5.0
    while len(got) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert [pk["stamp_ns"] for pk in got] == [50 * MS, 100 * MS]
    assert th.is_alive()  # waiting for the third frame's data
    p.stop()
    th.join(timeout=5.0)
    assert not th.is_alive()
    assert p.dropped_frames == 1 and not p._left


def test_right_frames_get_the_monotonic_guard():
    """Divergence from JAX live.py:172-180: a right frame not newer than
    the last one queued is dropped (counted in dropped_right_frames). Here
    the right frame at 60 ms arrives after the one at 100 ms: the port
    drops it, drops the left frame at 60 ms (its right stream has moved
    past it) and pairs the left frame at 100 ms with its own right frame.
    The JAX provider queues it, pairs the left frame at 60 ms with it by
    evicting the right frame at 100 ms, and the left frame at 100 ms is
    left without a partner."""
    def scenario(mod):
        p = mod.LiveDataProvider(stereo=True)
        feed_imu(p, 0, 300)
        p.push_right_frame(100 * MS, img(1))
        p.push_right_frame(60 * MS, img(2))  # out of order
        p.push_left_frame(60 * MS, img())
        p.push_left_frame(100 * MS, img())
        pks = [p.poll(), p.poll()]
        return p, [None if pk is None else (pk["stamp_ns"], int(p.load_image(pk["right_path"])[0, 0]))
                   for pk in pks]

    p, trace = scenario(tlive)
    assert trace == [(100 * MS, 1), None]
    assert p.dropped_right_frames == 1 and p.dropped_frames == 1
    _, j_trace = scenario(jlive)
    assert j_trace == [(60 * MS, 2), None]  # the JAX file's fault, named


# ---------------------------------------------------------------------------
# Bounded memory and query cost on a long mission (port only)
# ---------------------------------------------------------------------------


def test_imu_buffer_stays_bounded(monkeypatch):
    """Twenty horizons of IMU: the buffer holds about one horizon of
    samples in arrays that stop growing, and each query builds its block
    from the few samples around its interval."""
    sizes = []

    class Recording(tlive.ImuSynchronizer):
        def __init__(self, stamps_ns, *args, **kw):
            sizes.append(len(stamps_ns))
            super().__init__(stamps_ns, *args, **kw)

    monkeypatch.setattr(tlive, "ImuSynchronizer", Recording)
    buf = tlive.LiveImuBuffer(horizon_s=1.0)
    caps = []
    for k in range(20 * 200):  # 200 Hz for 20 s
        buf.push(k * 5 * MS, (0.0, 0.0, 9.81), (0.0, 0.0, 0.0))
        if k % 50 == 49:
            t1 = k * 5 * MS
            assert buf.query(t1 - 50 * MS, t1)[0] == buf.AVAILABLE
            caps.append(len(buf._t))
    assert len(buf.acc) <= 202
    assert max(caps) == caps[len(caps) // 4] <= 1024  # no growth after the first horizon
    assert len(sizes) == 80 and max(sizes) <= 12


def test_provider_releases_consumed_images():
    """A long stream through frames(), each packet's images loaded as the
    pipeline loads them: the provider holds no image of a consumed frame,
    and a second load of one raises."""
    p = tlive.LiveDataProvider(stereo=True)
    feed_imu(p, 0, 100)
    held, last = [], None
    for k in range(1, 301):
        t = k * 50
        feed_imu(p, 50 * k + 50, 50 * k + 100)
        p.push_right_frame(t * MS, img())
        p.push_left_frame(t * MS, img())
        pk = p.poll()
        assert pk is not None and pk["stamp_ns"] == t * MS
        p.load_image(pk["left_path"])
        p.load_image(pk["right_path"])
        held.append(len(p._images))
        last = pk
    assert max(held) == 0
    with pytest.raises(KeyError, match="consumed"):
        p.load_image(last["left_path"])


# ---------------------------------------------------------------------------
# Replayed live == offline (port-only counterpart of test_live_provider.py:148)
# ---------------------------------------------------------------------------

SIZE = dict(width=160, height=120, fx=120.0)


def _params():
    p = synthetic_params(**SIZE, nr_states=8, max_features=64, max_landmarks=96)
    p.frontend.klt_max_level = 2
    p.frontend.templ_cols = 31
    p.frontend.templ_rows = 7
    return p


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
def test_replayed_live_matches_offline_pipeline(parallel):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        off = SyntheticStereoProvider(n_frames=24, vx=0.5, **SIZE)
        out_off = StereoImuPipeline(_params(), parallel_run=False, device="cpu").run(off)
        src = SyntheticStereoProvider(n_frames=24, vx=0.5, **SIZE)
        live = tlive.LiveDataProvider(stereo=True, max_queued_frames=64)
        live.ground_truth = src.ground_truth  # the same bootstrap as offline
        feeder = threading.Thread(target=tlive.replay, args=(src, live))
        feeder.start()
        out_live = StereoImuPipeline(_params(), parallel_run=parallel, device="cpu").run(live)
        feeder.join()
    finally:
        torch.set_num_threads(n)
    assert live.dropped_frames == 0 and live.dropped_imu == 0
    assert not live._images  # every frame's images released once loaded
    assert out_live.n_frames == out_off.n_frames == 24
    assert out_live.n_keyframes == out_off.n_keyframes >= 4
    assert out_live.stamps_ns == out_off.stamps_ns
    np.testing.assert_allclose(np.stack(out_live.positions), np.stack(out_off.positions), atol=1e-6)
