"""LcdModule: the loop-closure detector wired onto a VIO run.

Port of kimera_vio_tpu/pipeline/lcd_module.py (the reference LcdModule,
src/loopclosure/LcdModule.cpp:30-66): keyframe-paced, fed backend poses
and either the keyframe's rectified stereo pair (`add_keyframe`, which
re-detects GFTT keypoints, computes ORB descriptors and rebuilds sparse
stereo with the shared matcher) or those features already extracted on
the device inside the frontend's keyframe branch (`add_keyframe_packed`).

Vocabulary: the packaged 4096-leaf tree (`data/`, the port's own copy),
the flat 256-word codebook when the tree is absent, or — with
`vocab_path=None` — a codebook trained by k-majority on the first
`vocab_train_kfs` keyframes, which are then processed in order.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from kimera_vio_tpu_torch import resolve_device
from kimera_vio_tpu_torch.frontend.vision_frontend import extract_lcd_features
from kimera_vio_tpu_torch.loopclosure.frame_cache import FrameCache
from kimera_vio_tpu_torch.loopclosure.lcd import LcdConfig, LoopClosureDetector
from kimera_vio_tpu_torch.loopclosure.vocab import (
    BowVocabulary,
    as_u32,
    as_words,
    load_vocabulary,
    train_vocabulary,
)

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


class LcdModule:
    #: the packaged vocabulary (the reference ships ORBvoc.yml the same
    #: way): the hierarchical k^L tree, 4096 leaves; the flat 256-word
    #: codebook is the fallback. A 32768-leaf tree is packaged too.
    DEFAULT_VOCAB = "bow_vocab_tree_4096.npz"
    FALLBACK_VOCAB = "bow_vocab_256.npz"

    def __init__(self, stereo, cfg: LcdConfig | None = None, n_features: int = 256,
                 vocab_train_kfs: int = 20, n_words: int = 256, cache_dir: str | None = None,
                 vocab_path: str | None = "default", lcd_params=None,
                 device: str | torch.device = "cuda", stats=None):
        self.device = resolve_device(device)
        self.stereo = stereo
        self.stats = stats
        if cfg is None and lcd_params is not None:
            cfg = LcdConfig.from_params(lcd_params)
        self.cfg = cfg or LcdConfig(n_features=n_features)
        self.n_features = self.cfg.n_features
        if vocab_path == "default":
            vocab_path = os.path.join(DATA_DIR, self.DEFAULT_VOCAB)
            if not os.path.exists(vocab_path):
                vocab_path = os.path.join(DATA_DIR, self.FALLBACK_VOCAB)
        if cache_dir is None:
            # Disk spill keeps verification working past the LRU bound; the
            # directory goes with this module.
            self._tmp = tempfile.TemporaryDirectory(prefix="kimera_lcd_cache_")
            cache_dir = self._tmp.name
        self.vocab_train_kfs = vocab_train_kfs
        self.n_words = n_words
        self._pending = []  # keyframes before vocabulary training
        self.lcd: LoopClosureDetector | None = None
        self.cache = FrameCache(cache_dir)
        if vocab_path and os.path.exists(vocab_path):
            self.lcd = self._detector(load_vocabulary(vocab_path))

    def _detector(self, vocab) -> LoopClosureDetector:
        return LoopClosureDetector(vocab, self.cfg, self.stereo, cache=self.cache,
                                   device=self.device, stats=self.stats)

    # ------------------------------------------------------------------
    def _extract(self, left_rect, right_rect):
        f = extract_lcd_features(self.stereo, left_rect, right_rect, self.n_features,
                                 self.cfg.min_distance)
        return (f["lcd_uv"].cpu().numpy(), f["lcd_ok"].cpu().numpy(), as_u32(f["lcd_desc"]),
                f["lcd_versors"].cpu().numpy(), f["lcd_pts3"].cpu().numpy())

    def add_keyframe_packed(self, uv, ok, desc, versors, pts3, pose_R, pose_t, stamp_ns):
        """A keyframe whose LCD features the frontend's keyframe branch
        already extracted on the device (host arrays)."""
        return self._add(np.asarray(uv), np.asarray(ok), as_u32(desc), np.asarray(versors),
                         np.asarray(pts3), pose_R, pose_t, stamp_ns)

    def add_keyframe(self, left_rect, right_rect, pose_R, pose_t, stamp_ns):
        """A keyframe's rectified stereo pair; returns a verified
        LoopResult or None."""
        dev = self.device
        uv, ok, desc, versors, pts3 = self._extract(
            torch.as_tensor(np.asarray(left_rect), dtype=torch.float32, device=dev),
            torch.as_tensor(np.asarray(right_rect), dtype=torch.float32, device=dev))
        return self._add(uv, ok, desc, versors, pts3, pose_R, pose_t, stamp_ns)

    def _add(self, uv, ok, desc, versors, pts3, pose_R, pose_t, stamp_ns):
        payload = dict(uv=uv, ok=ok, desc=desc, versors=versors, pts3=pts3,
                       pose_R=np.asarray(pose_R), pose_t=np.asarray(pose_t),
                       stamp=np.int64(stamp_ns))
        if self.lcd is None:
            self._pending.append(payload)
            if len(self._pending) >= self.vocab_train_kfs:
                self._finalize_vocab()
            return None
        return self._feed(payload)

    def _finalize_vocab(self):
        dev = self.device
        cb = train_vocabulary(
            as_words(np.concatenate([p["desc"] for p in self._pending]), dev),
            torch.as_tensor(np.concatenate([p["ok"] for p in self._pending]), device=dev),
            n_words=self.n_words, iters=6)
        self.lcd = self._detector(BowVocabulary(as_u32(cb)))
        for p in self._pending:
            self._feed(p)
        self._pending.clear()

    def _feed(self, p):
        return self.lcd.add_keyframe(None, p["uv"], p["ok"], p["versors"], p["pts3"],
                                     p["pose_R"], p["pose_t"], int(p["stamp"]),
                                     desc_override=(p["desc"], p["ok"]))

    # ------------------------------------------------------------------
    def finish(self):
        """Train the vocabulary even if short, then return the PGO result
        (optimized keyframe trajectory and the verified loops)."""
        if self.lcd is None and self._pending:
            self._finalize_vocab()
        if self.lcd is None or self.lcd.n_kf < 2:
            return None
        rot, pos = self.lcd.optimize_graph()
        return {"rot": rot, "pos": pos, "stamps": list(self.lcd.kf_stamps), "loops": self.lcd.loops}
