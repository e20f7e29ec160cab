"""Loop-closure detector: place recognition, geometric verification, PGO.

Port of kimera_vio_tpu/loopclosure/lcd.py (the reference
LoopClosureDetector, src/loopclosure/LoopClosureDetector.cpp:198-391).
Per keyframe:

  1. ORB-class descriptors on the keyframe image (orb.py), or the ones
     the caller extracted (`desc_override`);
  2. BoW transform and database query with NSS normalization against the
     previous keyframe (detectLoop :682-764), on the host through the
     inverted index (word -> postings of keyframe ids and weights);
  3. island grouping and the temporal check (LcdThirdPartyWrapper.cpp);
  4. geometric verification on the device: Lowe-ratio Hamming matching,
     5-pt essential RANSAC on bearings, then pose recovery by type
     (0 k3d3d Arun, 1 kPnP, 2 k5ptRotOnly) with the optional refinement;
  5. at the end, PCM gating, optional GNC weighting and pose-graph
     Gauss-Newton over odometry and verified loops (pgo.py).

RANSAC draws come from a `torch.Generator` seeded, for every solver of a
candidate pair, with the integer the reference seeds its PRNG key with
(match_id * 100003 + kf_id). Keyframe payloads live in the disk-backed
FrameCache. The BoW stage, each verification and the PGO are spans
(`lcd.bow_query`, `lcd.verify`, `lcd.pgo`); with a StatsCollector their
host times are recorded under "lcd ..." tags (each ends in a host read of
its device results).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kimera_vio_tpu_torch import resolve_device
from kimera_vio_tpu_torch.loopclosure import orb as orb_mod
from kimera_vio_tpu_torch.loopclosure import pgo as pgo_mod
from kimera_vio_tpu_torch.loopclosure.frame_cache import FrameCache
from kimera_vio_tpu_torch.loopclosure.vocab import BowVocabulary, as_u32, as_words
from kimera_vio_tpu_torch.ops import ransac
from kimera_vio_tpu_torch.utils.stats import span


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass
class LcdConfig:
    # Place recognition (LoopClosureDetectorParams.h:40-66)
    use_nss: bool = True
    alpha: float = 0.1  # BoW score threshold (x nss factor)
    min_nss_factor: float = 0.005
    recent_frames_window: int = 20
    max_db_results: int = 5
    # Island grouping + temporal constraint (LcdThirdPartyWrapper.cpp)
    min_temporal_matches: int = 3
    max_intraisland_gap: int = 3
    min_matches_per_island: int = 1
    max_nrFrames_between_islands: int = 3
    max_nrFrames_between_queries: int = 2
    # Geometric verification + pose recovery
    min_correspondences: int = 12
    lowe_ratio: float = 0.7
    ransac_threshold_mono: float = 1e-6
    arun_threshold_m: float = 0.15
    pnp_threshold_px: float = 3.0
    min_inliers: int = 10
    pose_recovery_type: int = 0  # 0 k3d3d, 1 kPnP, 2 k5ptRotOnly
    max_pose_recovery_translation: float = 1e3
    between_rotation_precision: float = 10000.0
    # Refinement of the recovered loop pose over the inliers (reference
    # refinePoses, LoopClosureDetector.cpp:979; header default true).
    refine_pose: bool = True
    # PGO (KimeraRPGO: PCM + optional GNC)
    pcm_rot_threshold: float = 0.1
    pcm_trans_threshold: float = 0.5
    gnc_alpha: float = 0.0  # 0 disables GNC
    n_features: int = 256
    min_distance: float = 12.0  # detector spacing for LCD features

    @classmethod
    def from_params(cls, p) -> "LcdConfig":
        """Build from a config.params.LcdParams (YAML tier)."""
        return cls(
            n_features=int(getattr(p, "nfeatures", 256) or 256),
            min_distance=float(getattr(p, "min_distance", 12.0)),
            use_nss=p.use_nss,
            alpha=p.alpha,
            min_nss_factor=p.min_nss_factor,
            recent_frames_window=p.recent_frames_window,
            max_db_results=p.max_db_results,
            min_temporal_matches=p.min_temporal_matches,
            max_intraisland_gap=p.max_intraisland_gap,
            min_matches_per_island=p.min_matches_per_island,
            max_nrFrames_between_islands=p.max_nrFrames_between_islands,
            max_nrFrames_between_queries=p.max_nrFrames_between_queries,
            min_correspondences=p.min_correspondences,
            refine_pose=p.refine_pose,
            lowe_ratio=p.lowe_ratio,
            ransac_threshold_mono=p.ransac_threshold_mono,
            arun_threshold_m=p.ransac_inlier_threshold_stereo,
            pose_recovery_type=p.pose_recovery_type,
            pcm_rot_threshold=p.pgo_rot_threshold,
            pcm_trans_threshold=p.pgo_trans_threshold,
            gnc_alpha=p.gnc_alpha,
        )


@dataclass
class LoopResult:
    query_id: int
    match_id: int
    R_match_query: np.ndarray
    t_match_query: np.ndarray
    n_inliers: int
    rot_only: bool = False  # k5ptRotOnly: translation rows carry ~no weight


@dataclass
class _Island:
    """MatchIsland (LcdThirdPartyWrapper.h): a contiguous-id candidate
    group with a summed score."""

    start: int
    end: int
    score: float
    best_id: int
    best_score: float


class LoopClosureDetector:
    """Host orchestrator of device kernels; keyframe-paced like the
    reference LcdModule."""

    def __init__(self, vocab, cfg: LcdConfig = LcdConfig(), stereo=None, cache=None,
                 device: str | torch.device = "cuda", stats=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.vocab = vocab
        self.stereo = stereo
        self.stats = stats
        self._post_ids: dict[int, list] = {}
        self._post_wts: dict[int, list] = {}
        self.n_kf = 0
        self.cache = cache if cache is not None else FrameCache(None)
        self.kf_pose: list = []  # odometry poses (R, t) world
        self.kf_stamps: list = []
        self.latest_bow = None
        self.loops: list[LoopResult] = []
        self._temporal_entries = 0
        self._latest_island: _Island | None = None
        self._latest_query_id = 0
        self.focal = float(stereo.fx) if stereo is not None else 450.0

    def _span(self, name: str, tag: str):
        """Span `name`, its milliseconds added to `tag` with a StatsCollector."""
        return span(name) if self.stats is None else self.stats.span(name, tag)

    def _t(self, x, dtype=None) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def add_keyframe(self, img, uv, mask, versors, pts3d, pose_R, pose_t, stamp_ns: int,
                     desc_override=None) -> LoopResult | None:
        """Process one keyframe; returns a verified loop or None.
        `desc_override=(desc, ok)` skips the ORB extraction."""
        cfg = self.cfg
        if desc_override is not None:
            desc, ok = desc_override
        else:
            desc, _, ok = orb_mod.orb_descriptors(
                self._t(img, torch.float32), self._t(uv, torch.float32), self._t(mask, torch.bool))
        desc, ok = as_u32(desc), _host(ok)
        kf_id = self.n_kf
        result = None
        candidate = None
        with self._span("lcd.bow_query", "lcd bow+query [ms]"):
            bow = self.vocab.transform_np(desc, ok)
            max_match = kf_id - cfg.recent_frames_window
            if max_match > 0:
                scores = self._query_index(bow, max_match)
                nss = 1.0
                if cfg.use_nss and self.latest_bow is not None:
                    nss = float(BowVocabulary.score_np(bow, self.latest_bow[None])[0])
                if not cfg.use_nss or nss >= cfg.min_nss_factor:
                    order = np.argsort(scores)[::-1][: cfg.max_db_results]
                    cand = [(int(c), float(scores[c])) for c in order
                            if scores[c] > cfg.alpha * max(nss, 1e-9)]
                    if cand:
                        islands = self._compute_islands(cand)
                        if islands:
                            best = max(islands, key=lambda i: i.score)
                            if self._check_temporal(kf_id, best):
                                candidate = cand[0][0]  # top scorer (detectLoop :738)
        if candidate is not None:
            with self._span("lcd.verify", "lcd verify [ms]"):
                result = self._verify(kf_id, candidate, desc, ok, uv, versors, pts3d)
            if result is not None:
                self.loops.append(result)

        self._insert_index(kf_id, bow)
        self.latest_bow = bow
        self.cache.add(kf_id, dict(desc=desc, ok=ok, uv=_host(uv), versors=_host(versors),
                                   pts3d=_host(pts3d)))
        self.kf_pose.append((_host(pose_R), _host(pose_t)))
        self.kf_stamps.append(stamp_ns)
        self.n_kf += 1
        return result

    # ------------------------------------------------------------------
    def _query_index(self, bow: np.ndarray, max_match: int) -> np.ndarray:
        """L1 BoW scores of `bow` against keyframes [0, max_match) through
        the inverted index, by the common-words identity for L1-normalised
        vectors: 1 - 0.5 |v - w|_1 = 0.5 sum_common (v_i + w_i - |v_i - w_i|)."""
        scores = np.zeros(max_match, np.float32)
        for w in np.flatnonzero(bow):
            ids = self._post_ids.get(int(w))
            if not ids:
                continue
            ids_a = np.asarray(ids, np.int64)
            wts_a = np.asarray(self._post_wts[int(w)], np.float32)
            sel = ids_a < max_match
            if not sel.any():
                continue
            v = float(bow[w])
            scores[ids_a[sel]] += v + wts_a[sel] - np.abs(v - wts_a[sel])
        return 0.5 * scores

    def _insert_index(self, kf_id: int, bow: np.ndarray):
        """Append this keyframe's nonzero words to the inverted file."""
        for w in np.flatnonzero(bow):
            self._post_ids.setdefault(int(w), []).append(kf_id)
            self._post_wts.setdefault(int(w), []).append(float(bow[w]))

    # ------------------------------------------------------------------
    def _compute_islands(self, cand: list[tuple[int, float]]) -> list[_Island]:
        """Group candidates into contiguous-id islands
        (LcdThirdPartyWrapper::computeIslands): gap < max_intraisland_gap,
        id-span >= min_matches_per_island; island score = sum of scores."""
        cfg = self.cfg
        by_id = sorted(cand)
        islands: list[_Island] = []
        first = last = by_id[0][0]
        ssum = best_score = by_id[0][1]
        best_id = by_id[0][0]
        for cid, sc in by_id[1:]:
            if cid - last < cfg.max_intraisland_gap:
                last = cid
                ssum += sc
                if sc > best_score:
                    best_score, best_id = sc, cid
            else:
                if last - first + 1 >= cfg.min_matches_per_island:
                    islands.append(_Island(first, last, ssum, best_id, best_score))
                first = last = cid
                ssum = best_score = sc
                best_id = cid
        if last - first + 1 >= cfg.min_matches_per_island:
            islands.append(_Island(first, last, ssum, best_id, best_score))
        return islands

    def _check_temporal(self, kf_id: int, island: _Island) -> bool:
        """checkTemporalConstraint (LcdThirdPartyWrapper.cpp:70-107):
        consecutive queries must hit overlapping or nearby islands more
        than min_temporal_matches times."""
        cfg = self.cfg
        if self._temporal_entries == 0 or kf_id - self._latest_query_id > cfg.max_nrFrames_between_queries:
            self._temporal_entries = 1
        else:
            a1, a2 = self._latest_island.start, self._latest_island.end
            b1, b2 = island.start, island.end
            overlap = (b1 <= a1 <= b2) or (a1 <= b1 <= a2)
            gap_small = False
            if not overlap:
                gap_small = max(a1 - b2, b1 - a2) <= cfg.max_nrFrames_between_islands
            self._temporal_entries = self._temporal_entries + 1 if (overlap or gap_small) else 1
        self._latest_island = island
        self._latest_query_id = kf_id
        return self._temporal_entries > cfg.min_temporal_matches

    # ------------------------------------------------------------------
    def _generator(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    def _verify(self, kf_id, match_id, desc_q, ok_q, uv_q, versors_q, pts_q):
        """Descriptor matching + 2d2d verification + pose recovery by type
        (verifyAndRecoverPose :766-806, recoverPoseBody :851-980)."""
        cfg = self.cfg
        payload = self.cache.get(match_id)
        if payload is None:
            return None  # evicted without a disk directory
        dev = self.device
        idx, mok = orb_mod.match_descriptors(
            as_words(desc_q, dev), self._t(ok_q, torch.bool),
            as_words(payload["desc"], dev), self._t(payload["ok"], torch.bool),
            lowe_ratio=cfg.lowe_ratio)
        idx, mok = idx.cpu().numpy(), mok.cpu().numpy()
        if mok.sum() < cfg.min_correspondences:
            return None
        pair_ok = self._t(mok)
        seed = match_id * 100003 + kf_id
        v_q = self._t(versors_q, torch.float32)
        v_m = self._t(np.asarray(payload["versors"])[idx], torch.float32)
        R2, t2, _, n2 = ransac.ransac_5pt_mono(v_m, v_q, pair_ok, self._generator(seed),
                                              threshold=cfg.ransac_threshold_mono)
        if int(n2) < cfg.min_inliers:
            return None
        rot_only = False
        if cfg.pose_recovery_type == 2:  # k5ptRotOnly
            R, t, n_inl = R2.cpu().numpy(), t2.cpu().numpy(), int(n2)
            rot_only = True
        elif cfg.pose_recovery_type == 1:  # kPnP: query bearings vs match 3D points
            p_m = self._t(np.asarray(payload["pts3d"])[idx], torch.float32)
            R_cw, t_cw, inl, n_inl = ransac.ransac_pnp(
                p_m, v_q, pair_ok, self._generator(seed),
                threshold=cfg.pnp_threshold_px, focal=self.focal)
            if cfg.refine_pose:
                R_cw, t_cw = ransac.refine_pnp_gn(p_m, v_q, inl, R_cw, t_cw, focal=self.focal,
                                                  huber_px=cfg.pnp_threshold_px)
            # x_q = R_cw x_m + t_cw => T_match_query = inv([R_cw t_cw]).
            R = R_cw.cpu().numpy().T
            t = -R @ t_cw.cpu().numpy()
            n_inl = int(n_inl)
            if np.linalg.norm(t) > cfg.max_pose_recovery_translation:
                return None
        else:  # k3d3d (default): Arun RANSAC on stereo backprojections
            p_q = self._t(pts_q, torch.float32)
            p_m = self._t(np.asarray(payload["pts3d"])[idx], torch.float32)
            R3, t3, inl, n_inl = ransac.ransac_3pt_arun(
                p_m, p_q, pair_ok, self._generator(seed), threshold=cfg.arun_threshold_m)
            if cfg.refine_pose:
                R3, t3 = ransac.refine_arun_huber(p_m, p_q, inl, R3, t3,
                                                  huber_m=0.5 * cfg.arun_threshold_m)
            R, t, n_inl = R3.cpu().numpy(), t3.cpu().numpy(), int(n_inl)
        if n_inl < cfg.min_inliers:
            return None
        return LoopResult(query_id=kf_id, match_id=match_id, R_match_query=R,
                          t_match_query=t, n_inliers=n_inl, rot_only=rot_only)

    # ------------------------------------------------------------------
    def optimize_graph(self):
        """PCM + optional GNC + pose-graph Gauss-Newton over odometry and
        verified loops; returns (rot (K,3,3), pos (K,3)) on the host."""
        with self._span("lcd.pgo", "lcd pgo [ms]"):
            return self._optimize_graph()

    def _optimize_graph(self):
        K = self.n_kf
        rot = self._t(np.stack([p[0] for p in self.kf_pose]), torch.float32)
        pos = self._t(np.stack([p[1] for p in self.kf_pose]), torch.float32)
        ei, ej = list(range(K - 1)), list(range(1, K))
        Rm, tm = [], []
        for i, j in zip(ei, ej):
            Ri, ti = self.kf_pose[i]
            Rj, tj = self.kf_pose[j]
            Rm.append(Ri.T @ Rj)
            tm.append(Ri.T @ (tj - ti))
        w = [1.0] * len(ei)
        n_odom = len(ei)
        kept_loops: list[LoopResult] = []
        if self.loops:
            keep = pgo_mod.pcm_consistency(
                rot, pos,
                self._t([l.match_id for l in self.loops], torch.int64),
                self._t([l.query_id for l in self.loops], torch.int64),
                self._t(np.stack([l.R_match_query for l in self.loops]), torch.float32),
                self._t(np.stack([l.t_match_query for l in self.loops]), torch.float32),
                torch.ones(len(self.loops), dtype=torch.bool, device=self.device),
                rot_threshold=self.cfg.pcm_rot_threshold,
                trans_threshold=self.cfg.pcm_trans_threshold,
            ).cpu().numpy()
            for k, l in enumerate(self.loops):
                if keep[k]:
                    ei.append(l.match_id)
                    ej.append(l.query_id)
                    Rm.append(l.R_match_query)
                    tm.append(l.t_match_query)
                    # Rotation-only loops keep a finite translation weight.
                    w.append(1e-3 if l.rot_only else 1.0)
                    kept_loops.append(l)
        edges = (self._t(ei, torch.int64), self._t(ej, torch.int64),
                 self._t(np.stack(Rm), torch.float32), self._t(np.stack(tm), torch.float32))
        w = self._t(np.asarray(w, np.float32))
        if self.cfg.gnc_alpha > 0.0 and kept_loops:
            rot2, pos2 = self._gnc_optimize(rot, pos, edges, w, n_odom)
        else:
            rot2, pos2, _ = pgo_mod.optimize_pose_graph(rot, pos, *edges, w)
        return rot2.cpu().numpy(), pos2.cpu().numpy()

    def _gnc_optimize(self, rot, pos, edges, w0, n_odom):
        """Graduated non-convexity on the loop-edge weights (GM-style
        surrogate, mu annealed 16 -> 1 then held): solve, reweight by the
        residuals, repeat; odometry edges keep weight 1 (KimeraRPGO
        GncOptimizer with fixed odometry)."""
        ei, ej, Rm, tm = edges
        barc2 = float(np.float32((0.2 * self.cfg.pcm_trans_threshold) ** 2))
        w_cur = w0
        for mu in (16.0, 8.0, 4.0, 2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0):
            rot2, pos2, _ = pgo_mod.optimize_pose_graph(rot, pos, ei, ej, Rm, tm, w_cur)
            r2 = pgo_mod.edge_chi2(rot2, pos2, ei, ej, Rm, tm)
            w_gnc = (mu * barc2 / (r2 + mu * barc2)) ** 2
            w_cur = torch.cat([w0[:n_odom], w0[n_odom:] * w_gnc[n_odom:]])
        rot2, pos2, _ = pgo_mod.optimize_pose_graph(rot, pos, ei, ej, Rm, tm, w_cur)
        self.gnc_weights = w_cur[n_odom:].cpu().numpy()
        return rot2, pos2
