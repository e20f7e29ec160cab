"""The port's staging codecs (ops/frame_codec.py) against the JAX package's.

  * Encoders: each port encoder's wire, native and its numpy twin, is
    byte-identical to the JAX encoder's on seeded uint8 video with escapes
    (delta4, delta4c from planes and from a stack, delta3), also where a
    delta4c escape gap needs filler tokens (a gap over 65,535). Each
    declines (None) exactly where the JAX one does: escape overflow,
    non-uint8 input, an odd frame size, F < 2, delta3 on noise.
  * Decoders: the port's torch decoders on the CPU rebuild the exact
    frames (and delta4c's float32 aux bit for bit) from the JAX encoders'
    wire, equal to the JAX decoders' output.
  * Staging: `_stage` follows the JAX decline chain (delta3 -> delta4,
    non-uint8 -> raw) and packs the JAX wire into its one staging
    buffer, which ends where the wire does; and `run_chunked` under each `KIMERA_STAGE_CODEC`
    value gives keyframes, positions and quaternions bit for bit equal to
    raw staging on a uint8-quantised `SyntheticStereoProvider` (the
    wrapper of tests/test_pipeline_e2e.py:451-454, at 160x120). At vx 0.1
    m/s every super-batch is staged in the codec named; at vx 0.5 m/s the
    texture moves ~0.6 px a frame, most deltas escape and every codec
    declines to raw. An unknown codec name stages delta4, as in the JAX
    package.
"""

import numpy as np
import pytest
import torch

from kimera_vio_tpu.ops import frame_codec as jfc
from kimera_vio_tpu_torch.common.types import ImuBlock
from kimera_vio_tpu_torch.dataprovider.synthetic import SyntheticStereoProvider, synthetic_params
from kimera_vio_tpu_torch.ops import frame_codec as tfc
from kimera_vio_tpu_torch.pipeline.stereo_pipeline import StereoImuPipeline

SIZE = dict(width=160, height=120, fx=120.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the machine's cores,
    and these small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def video(F=6, shape=(2, 24, 32), esc=0.05, seed=0):
    """(F, *shape) uint8 frames: small temporal deltas, and a fraction
    `esc` of large ones that escape every tier."""
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, shape, dtype=np.uint8)]
    for _ in range(F - 1):
        d = rng.integers(-5, 6, shape)
        big = rng.random(shape) < esc
        d[big] = rng.integers(-128, 128, int(big.sum()))
        frames.append(((frames[-1].astype(np.int64) + d) % 256).astype(np.uint8))
    return np.stack(frames)


def aux_rows(F, seed=1):
    return np.random.default_rng(seed).standard_normal((F, 17)).astype(np.float32)


def assert_same_wire(a, b):
    assert a is not None and b is not None
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == b[k].dtype and v.shape == b[k].shape, k
            np.testing.assert_array_equal(v, b[k], err_msg=k)
        else:
            assert v == b[k], k


ENCODERS = {
    "delta4": (jfc.encode_delta4, tfc.encode_delta4, tfc.encode_delta4_plain),
    "delta3": (jfc.encode_delta3, tfc.encode_delta3, tfc.encode_delta3_plain),
    "delta4c": (lambda f: jfc.encode_delta4c(f, aux_rows(len(f))),
                lambda f: tfc.encode_delta4c(f, aux_rows(len(f))),
                lambda f: tfc.encode_delta4c_plain(f, aux_rows(len(f)))),
}


@pytest.mark.parametrize("variant", ["native", "plain"])
@pytest.mark.parametrize("codec", sorted(ENCODERS))
def test_encoder_wire_is_the_jax_wire(codec, variant):
    j_enc, t_native, t_plain = ENCODERS[codec]
    frames = video()
    enc = (t_native if variant == "native" else t_plain)(frames)
    assert_same_wire(enc, j_enc(frames))
    assert tfc.wire_bytes(enc) == jfc.wire_bytes(enc)


def test_delta4c_planes_wire_is_the_jax_wire():
    """From per-image planes (the stager's route), also with planes of
    odd size, which the encoder stacks into whole frames."""
    for shape in ((2, 24, 32), (2, 5, 7)):
        frames = video(shape=shape)
        planes = [im for f in frames for im in f]
        aux = aux_rows(len(frames))
        enc = tfc.encode_delta4c_planes(planes, 2, frames.shape, aux)
        assert_same_wire(enc, jfc.encode_delta4c_planes(planes, 2, frames.shape, aux))
        assert_same_wire(enc, tfc.encode_delta4c(frames, aux))


def test_delta4c_gap_fillers():
    """Escapes 2 x 65,535 + 7 pixels apart: filler tokens (0) on the wire."""
    frames = np.zeros((3, 2, 200, 400), np.uint8)
    flat = frames.reshape(3, -1)
    flat[1, 3] = 100
    flat[1, 3 + 2 * 65535 + 7] = 200
    flat[2, 11] = 50
    aux = aux_rows(3)
    enc = tfc.encode_delta4c(frames, aux)
    assert_same_wire(enc, jfc.encode_delta4c(frames, aux))
    assert_same_wire(enc, tfc.encode_delta4c_plain(frames, aux))
    S = frames[0].size
    o = S + 2 * S // 2
    lo, hi = enc["buf"][o : o + 4], enc["buf"][o + enc["n_tok"] : o + enc["n_tok"] + 4]
    tok = lo.astype(np.int64) | (hi.astype(np.int64) << 8)
    # The escape at 3, two fillers, the escape 2 x 65535 + 7 later.
    assert tok.tolist() == [4, 0, 0, 7]
    out, aux_t = tfc.decode_delta4c(torch.from_numpy(enc["buf"]), enc["shape"], enc["n_tok"],
                                    enc["aux_shape"])
    np.testing.assert_array_equal(out.numpy(), frames)
    np.testing.assert_array_equal(aux_t.numpy().view(np.uint32), aux.view(np.uint32))


NOISE = np.random.default_rng(3).integers(0, 256, (4, 2, 32, 32), dtype=np.uint8)


@pytest.mark.parametrize("case,frames", [
    ("escape overflow", NOISE),
    ("non-uint8", video().astype(np.float32)),
    ("odd frame size", video(shape=(3, 5))),
    ("one frame", video(F=1)),
])
@pytest.mark.parametrize("codec", sorted(ENCODERS))
def test_encoders_decline_where_jax_declines(codec, case, frames):
    j_enc, t_native, t_plain = ENCODERS[codec]
    want = j_enc(frames)
    if case == "odd frame size" and codec == "delta3":
        # delta3 has no nibble pairs: it takes an odd frame size.
        assert_same_wire(t_native(frames), want)
        assert_same_wire(t_plain(frames), want)
        return
    # delta3 on noise: more than a third of the pixels escape tier 1.
    assert want is None
    assert t_native(frames) is None and t_plain(frames) is None


def test_decoders_rebuild_the_jax_wire():
    frames = video(F=7, seed=4)
    aux = aux_rows(7)
    T = torch.from_numpy

    e = jfc.encode_delta4(frames)
    out = tfc.decode_delta4(*(T(np.ascontiguousarray(e[k])) for k in
                              ("base", "packed", "esc_idx", "esc_val")), e["shape"])
    want = jfc.decode_delta4(e["base"], e["packed"], e["esc_idx"], e["esc_val"], e["shape"])
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    np.testing.assert_array_equal(out.numpy(), frames)
    assert out.dtype == torch.uint8

    e = jfc.encode_delta3(frames)
    out = tfc.decode_delta3(*(T(np.ascontiguousarray(e[k])) for k in ("base", "t1", "t2", "t3")),
                            e["shape"])
    want = jfc.decode_delta3(e["base"], e["t1"], e["t2"], e["t3"], e["shape"])
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    np.testing.assert_array_equal(out.numpy(), frames)

    e = jfc.encode_delta4c(frames, aux)
    out, aux_t = tfc.decode_delta4c(T(e["buf"]), e["shape"], e["n_tok"], e["aux_shape"])
    want, want_aux = jfc.decode_delta4c(e["buf"], e["shape"], e["n_tok"], e["aux_shape"])
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    np.testing.assert_array_equal(out.numpy(), frames)
    assert aux_t.dtype == torch.float32 and aux_t.shape == aux.shape
    np.testing.assert_array_equal(aux_t.numpy().view(np.uint32),
                                  np.asarray(want_aux).view(np.uint32))
    np.testing.assert_array_equal(aux_t.numpy().view(np.uint32), aux.view(np.uint32))


# ---------------------------------------------------------------------------
# Staging in the pipeline
# ---------------------------------------------------------------------------


class _Frames:
    """A provider of given images: load_image(key) returns images[key]."""

    def __init__(self, images):
        self.images = images

    def load_image(self, key):
        return self.images[key]


def _batch(frames_lr, B=4):
    """Packets of (F, 2, H, W) frames with seeded IMU blocks."""
    rng = np.random.default_rng(5)
    images, batch = {}, []
    for i, (left, right) in enumerate(frames_lr):
        images[("l", i)], images[("r", i)] = left, right
        blk = ImuBlock(acc=torch.from_numpy(rng.standard_normal((B, 3)).astype(np.float32)),
                       gyr=torch.from_numpy(rng.standard_normal((B, 3)).astype(np.float32)),
                       dt=torch.full((B,), 0.005), mask=torch.tensor([True] * (B - 1) + [False]))
        batch.append({"left_path": ("l", i), "right_path": ("r", i), "imu": blk})
    return _Frames(images), batch


@pytest.mark.parametrize("codec,frames,lands", [
    ("delta4c", video(F=5, shape=(2, 24, 32), esc=0.01), "delta4c"),
    ("delta3", video(F=5, shape=(2, 24, 32), esc=0.01), "delta3"),
    # Every delta +5: a tier-1 escape everywhere (delta3 declines), a
    # delta4 nibble everywhere.
    ("delta3", np.stack([np.full((2, 24, 32), 5 * t, np.uint8) for t in range(5)]), "delta4"),
    ("delta4c", video(F=5).astype(np.float32), "raw"),
])
def test_stage_follows_the_jax_decline_chain(codec, frames, lands):
    """One staged super-batch lands on the codec the JAX chain picks, and
    decodes to the frames and the IMU rows bit for bit."""
    pipe = StereoImuPipeline(synthetic_params(**SIZE, max_features=64, max_landmarks=96),
                             device="cpu")
    provider, batch = _batch(frames)
    staged = pipe._stage(provider, batch, None, codec)
    assert staged.codec == lands
    out, aux = pipe._materialize(staged)
    np.testing.assert_array_equal(out.numpy(), frames)
    for i, p in enumerate(batch):
        blk = p["imu"]
        want = np.concatenate([blk.acc.numpy().ravel(), blk.gyr.numpy().ravel(), blk.dt.numpy(),
                               blk.mask.numpy().astype(np.float32)])
        np.testing.assert_array_equal(aux[i].numpy().view(np.uint32), want.view(np.uint32))


def _aux_of(batch):
    return np.stack([np.concatenate([p["imu"].acc.numpy().ravel(), p["imu"].gyr.numpy().ravel(),
                                     p["imu"].dt.numpy(), p["imu"].mask.numpy().astype(np.float32)])
                     for p in batch])


@pytest.mark.parametrize("codec", ["delta4", "delta4c", "delta3"])
def test_stage_packs_the_jax_wire_into_its_one_buffer(codec):
    """Each wire part in the staging buffer is the JAX encoder's, byte for
    byte, at a 16-byte aligned offset, and the buffer ends where its last
    part does (nothing but the wire is copied to the card)."""
    frames = video(F=5, shape=(2, 24, 32), esc=0.01)
    pipe = StereoImuPipeline(synthetic_params(**SIZE, max_features=64, max_landmarks=96),
                             device="cpu")
    provider, batch = _batch(frames)
    staged = pipe._stage(provider, batch, None, codec)
    assert staged.codec == codec
    aux = _aux_of(batch)
    if codec == "delta4c":
        want = {"wire": jfc.encode_delta4c(frames, aux)["buf"]}
    else:
        enc = (jfc.encode_delta3 if codec == "delta3" else jfc.encode_delta4)(frames)
        want = {**{k: enc[k] for k in staged.parts if k != "aux"}, "aux": aux}
    assert list(want) == list(staged.parts)
    host = staged.host.numpy()
    for name, (start, dtype, shape) in staged.parts.items():
        assert start % 16 == 0
        got = host[start:start + int(np.prod(shape)) * dtype.itemsize].view(dtype).reshape(shape)
        np.testing.assert_array_equal(got, np.asarray(want[name]), err_msg=name)
    start, dtype, shape = staged.parts[next(reversed(staged.parts))]
    assert staged.host.numel() == start + int(np.prod(shape)) * dtype.itemsize


class Uint8Provider(SyntheticStereoProvider):
    """The synthetic renderer's images rounded to uint8, as a EuRoC folder
    holds them (tests/test_pipeline_e2e.py:451-454)."""

    def load_image(self, key):
        return np.clip(super().load_image(key), 0, 255).astype(np.uint8)


def _run_chunked(monkeypatch, codec, vx):
    p = synthetic_params(**SIZE, nr_states=8, max_features=64, max_landmarks=96)
    p.frontend.klt_max_level = 2
    p.frontend.templ_cols = 31
    p.frontend.templ_rows = 7
    monkeypatch.setenv("KIMERA_STAGE_CODEC", codec)
    pipe = StereoImuPipeline(p, parallel_run=False, device="cpu")
    # 29 frames after the first in super-batches of 8 (4 chunks of 2).
    out = pipe.run_chunked(Uint8Provider(n_frames=30, vx=vx, **SIZE), chunk_size=2,
                           super_batch_bytes=8 * 2 * 160 * 120)
    landed = {t.split()[2]: pipe.stats.get(t).count for t in pipe.stats.tags()
              if t.startswith("stage codec ")}
    return out, landed


_RAW = {}


@pytest.mark.parametrize("codec,vx,lands", [
    ("raw", 0.1, "raw"), ("delta4", 0.1, "delta4"), ("delta4c", 0.1, "delta4c"),
    ("delta3", 0.1, "delta3"), ("delta5", 0.1, "delta4"),
    ("delta4c", 0.5, "raw"), ("delta3", 0.5, "raw"),
])
def test_run_chunked_codecs_equal_raw_staging(monkeypatch, codec, vx, lands):
    if vx not in _RAW:
        _RAW[vx] = _run_chunked(monkeypatch, "raw", vx)[0]
    raw = _RAW[vx]
    out, landed = _run_chunked(monkeypatch, codec, vx)
    assert out.n_keyframes >= 3
    # Super-batches of 8 frames raw, 12 at delta4's wire factor, 16 at delta3's.
    assert set(landed) == {lands} and landed[lands] >= 2
    assert out.stamps_ns == raw.stamps_ns
    np.testing.assert_array_equal(np.stack(out.positions), np.stack(raw.positions))
    np.testing.assert_array_equal(np.stack(out.quats_wxyz), np.stack(raw.quats_wxyz))
