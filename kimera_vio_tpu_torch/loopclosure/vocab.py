"""Binary bag-of-words vocabularies (the DBoW2 replacement).

Port of kimera_vio_tpu/loopclosure/vocab.py:

  * `BowVocabulary`: a flat codebook of binary centroids, one Hamming
    argmin per descriptor;
  * `HierarchicalBowVocabulary`: a complete k-ary tree of binary
    centroids (DBoW2's k^L structure), descended level by level;
  * k-majority training: flat `train_vocabulary` (torch, on the device)
    and recursive `train_hierarchical_vocabulary` (numpy, training time);
  * tf-idf weighted, L1-normalised BoW vectors and the DBoW2 L1 score
    s(v, w) = 1 - 0.5 |v - w|_1.

Words are uint32 on the host (numpy) and int32 bit patterns on the
device (loopclosure/orb.py). The host twins (`transform_np`, `score_np`)
are what the detector uses per keyframe, as in the reference; the host
popcount is a byte table, so no numpy version is assumed.
"""

from __future__ import annotations

import numpy as np
import torch

from kimera_vio_tpu_torch.loopclosure.orb import hamming_matrix, pack_bits, popcount, unpack_bits

_POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def as_u32(words) -> np.ndarray:
    """Descriptor words on the host as contiguous uint32 (int32 bit
    patterns are reinterpreted, other integer types converted)."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    words = np.asarray(words)
    if words.dtype == np.int32:
        return np.ascontiguousarray(words).view(np.uint32)
    return np.ascontiguousarray(words, dtype=np.uint32)


def as_words(words, device) -> torch.Tensor:
    """Descriptor words as a device tensor (uint32 -> int32 bit patterns)."""
    if isinstance(words, torch.Tensor):
        return words.to(device)
    words = np.array(words)  # a writable copy for torch
    if words.dtype == np.uint32:
        words = words.view(np.int32)
    return torch.from_numpy(words).to(device)


def _popcount_np(x: np.ndarray) -> np.ndarray:
    """Set bits of each element of a uint32 array."""
    x = np.ascontiguousarray(x, np.uint32)
    return _POP8[x.view(np.uint8)].reshape(x.shape + (4,)).sum(-1, dtype=np.int64)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 8) x (M, 8) uint32 -> (N, M) popcount distances."""
    return _popcount_np(np.bitwise_xor(a[:, None, :], b[None, :, :])).sum(-1)


def train_vocabulary(descs: torch.Tensor, mask: torch.Tensor, n_words: int = 512, iters: int = 8,
                     seed: int = 0, init_idx: torch.Tensor | None = None):
    """k-majority clustering of binary descriptors (M, 8) int32. Returns
    the codebook (n_words, 8) int32. The initial centres are `n_words`
    masked descriptors drawn from a generator seeded with `seed` (the
    reference draws them with `jax.random.choice`), or `init_idx`."""
    M = descs.shape[0]
    if init_idx is None:
        gen = torch.Generator(device=descs.device)
        gen.manual_seed(seed)
        p = mask.to(torch.float32)
        init_idx = torch.multinomial(p / torch.clamp(p.sum(), min=1e-9), n_words,
                                     replacement=True, generator=gen)
    centers = descs[init_idx]
    bits = unpack_bits(descs).to(torch.float32)  # (M, 256)
    maskf = mask.to(torch.float32)
    for _ in range(iters):
        d = hamming_matrix(descs, centers)
        d = torch.where(mask[:, None], d, torch.full_like(d, 1 << 20))
        assign = torch.argmin(d, dim=1)
        onehot = torch.nn.functional.one_hot(assign, centers.shape[0]).to(torch.float32) * maskf[:, None]
        counts = onehot.sum(0)
        sums = onehot.T @ bits
        maj = sums > 0.5 * torch.clamp(counts[:, None], min=1e-9)
        centers = torch.where((counts < 1)[:, None], centers, pack_bits(maj))
    return centers


def _l1_normalise(tf: np.ndarray, idf: np.ndarray) -> np.ndarray:
    v = tf * idf
    return (v / max(float(np.abs(v).sum()), 1e-9)).astype(np.float32)


class BowVocabulary:
    """Codebook + idf weights + BoW transform and scoring."""

    def __init__(self, codebook, idf=None):
        self.codebook = codebook  # (W, 8) words
        self.n_words = codebook.shape[0]
        self.idf = np.ones(self.n_words, np.float32) if idf is None else np.asarray(idf, np.float32)

    def transform(self, desc: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Descriptors -> L1-normalised tf-idf BoW vector (W,), on the
        descriptors' device."""
        dev = desc.device
        d = hamming_matrix(desc, as_words(self.codebook, dev))
        word = torch.argmin(d, dim=1)
        tf = torch.zeros(self.n_words, dtype=torch.float32, device=dev).index_add_(
            0, word, mask.to(torch.float32))
        v = tf * torch.from_numpy(self.idf).to(dev)
        return v / torch.clamp(torch.abs(v).sum(), min=1e-9)

    @staticmethod
    def score(v: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
        """DBoW2 L1 score of v (W,) against db (K, W): 1 - 0.5 |v - w|_1."""
        return 1.0 - 0.5 * torch.abs(v[None, :] - db).sum(-1)

    def transform_np(self, desc, mask) -> np.ndarray:
        """Host twin of `transform` (the per-keyframe path)."""
        word = _hamming_np(as_u32(desc), as_u32(self.codebook)).argmin(1)
        tf = np.zeros(self.n_words, np.float32)
        np.add.at(tf, word, np.asarray(mask).astype(np.float32))
        return _l1_normalise(tf, self.idf)

    @staticmethod
    def score_np(v, db) -> np.ndarray:
        return 1.0 - 0.5 * np.abs(np.asarray(v)[None, :] - np.asarray(db)).sum(-1)

    def save(self, path: str):
        np.savez(path, codebook=as_u32(self.codebook), idf=self.idf)

    @classmethod
    def load(cls, path: str) -> "BowVocabulary":
        d = np.load(path)
        return cls(d["codebook"], d["idf"])


# ---------------------------------------------------------------------------
# Hierarchical (k^L) vocabulary — the DBoW2 tree structure
# ---------------------------------------------------------------------------


def _kmajority_np(descs, k, iters, rng):
    """Host k-majority over (M, 8) uint32 rows; returns (k, 8) centres.
    Empty clusters keep their previous centre."""
    M = descs.shape[0]
    if M == 0:
        return np.zeros((k, 8), np.uint32)
    centers = descs[rng.choice(M, size=k, replace=M < k)]
    bits = np.unpackbits(descs.view(np.uint8), axis=1, bitorder="little").astype(np.float32)
    for _ in range(iters):
        assign = _hamming_np(descs, centers).argmin(1)
        counts = np.bincount(assign, minlength=k).astype(np.float32)
        sums = np.zeros((k, 256), np.float32)
        np.add.at(sums, assign, bits)
        maj = sums > 0.5 * np.maximum(counts[:, None], 1e-9)
        new = np.packbits(maj.astype(np.uint8), axis=1, bitorder="little").view(np.uint32)
        centers = np.where(counts[:, None] < 1, centers, new)
    return np.ascontiguousarray(centers, np.uint32)


def train_hierarchical_vocabulary(descs, mask, k: int = 8, depth: int = 4, iters: int = 6,
                                  seed: int = 0) -> list[np.ndarray]:
    """Recursive k-majority over a complete k-ary tree (DBoW2 training).
    Returns per-level centroid arrays: levels[l] is (k**(l+1), 8); the
    children of node n at level l are rows n*k .. n*k+k-1. A node that
    receives no descriptors repeats its parent in every child slot."""
    rng = np.random.default_rng(seed)
    descs = np.ascontiguousarray(as_u32(descs)[np.asarray(mask, bool)])
    levels: list[np.ndarray] = []
    assign = np.zeros(descs.shape[0], np.int64)
    n_nodes = 1
    for lvl in range(depth):
        centers = np.zeros((n_nodes * k, 8), np.uint32)
        new_assign = np.zeros_like(assign)
        for node in range(n_nodes):
            sel = assign == node
            sub = descs[sel]
            if sub.shape[0] == 0:
                if lvl > 0:
                    centers[node * k: node * k + k] = levels[lvl - 1][node]
                continue
            c = _kmajority_np(sub, k, iters, rng)
            centers[node * k: node * k + k] = c
            new_assign[sel] = node * k + _hamming_np(sub, c).argmin(1)
        levels.append(centers)
        assign = new_assign
        n_nodes *= k
    return levels


class HierarchicalBowVocabulary:
    """DBoW2-structured k^L vocabulary tree, with `BowVocabulary`'s
    interface (n_words / transform / transform_np / score / save / load)."""

    def __init__(self, levels, idf=None):
        self.levels = [np.ascontiguousarray(as_u32(l)) for l in levels]
        self.k = int(self.levels[0].shape[0])
        self.depth = len(self.levels)
        self.n_words = int(self.levels[-1].shape[0])
        self.idf = np.ones(self.n_words, np.float32) if idf is None else np.asarray(idf, np.float32)

    def words_np(self, desc) -> np.ndarray:
        """(N, 8) words -> (N,) leaf ids by tree descent."""
        desc = as_u32(desc)
        cur = np.zeros(desc.shape[0], np.int64)
        for centers in self.levels:
            cand = centers.reshape(-1, self.k, 8)[cur]  # (N, k, 8)
            d = _popcount_np(np.bitwise_xor(desc[:, None, :], cand)).sum(-1)
            cur = cur * self.k + d.argmin(1)
        return cur

    def transform_np(self, desc, mask) -> np.ndarray:
        tf = np.zeros(self.n_words, np.float32)
        np.add.at(tf, self.words_np(desc), np.asarray(mask).astype(np.float32))
        return _l1_normalise(tf, self.idf)

    def transform(self, desc: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Device twin of `transform_np`."""
        dev = desc.device
        cur = torch.zeros(desc.shape[0], dtype=torch.int64, device=dev)
        for centers in self.levels:
            cand = as_words(centers, dev).reshape(-1, self.k, 8)[cur]  # (N, k, 8)
            d = torch.sum(popcount(desc[:, None, :] ^ cand), dim=-1)
            cur = cur * self.k + torch.argmin(d, dim=1)
        tf = torch.zeros(self.n_words, dtype=torch.float32, device=dev).index_add_(
            0, cur, mask.to(torch.float32))
        v = tf * torch.from_numpy(self.idf).to(dev)
        return v / torch.clamp(torch.abs(v).sum(), min=1e-9)

    score = staticmethod(BowVocabulary.score)
    score_np = staticmethod(BowVocabulary.score_np)

    def save(self, path: str):
        arrays = {f"level_{i}": l for i, l in enumerate(self.levels)}
        np.savez_compressed(path, idf=self.idf, tree_k=self.k, **arrays)

    @classmethod
    def load(cls, path: str) -> "HierarchicalBowVocabulary":
        d = np.load(path)
        n = sum(1 for k in d.files if k.startswith("level_"))
        return cls([d[f"level_{i}"] for i in range(n)], d["idf"])


def load_vocabulary(path: str):
    """Open either vocabulary format (the ORBvoc.yml-load role)."""
    d = np.load(path)
    if any(k.startswith("level_") for k in d.files):
        return HierarchicalBowVocabulary.load(path)
    return BowVocabulary.load(path)


def compute_idf(per_frame_words: list[np.ndarray], n_words: int) -> np.ndarray:
    """DBoW2 tf-idf weighting: idf_i = log(N_frames / n_frames_containing_i)."""
    df = np.zeros(n_words, np.float64)
    for w in per_frame_words:
        df[np.unique(w)] += 1.0
    n = max(len(per_frame_words), 1)
    return np.where(df > 0, np.log(n / np.maximum(df, 1e-9)), 0.0).astype(np.float32)
