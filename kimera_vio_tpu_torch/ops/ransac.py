"""Batched geometric verification: 2-pt mono RANSAC, 1-pt stereo voting.

Port of the main-path solvers of kimera_vio_tpu/ops/ransac.py: every
hypothesis of a fixed batch is scored against every correspondence at
once. Hypothesis samples come from a `torch.Generator` (the reference
draws them with `jax.random.choice`, a stream torch cannot reproduce);
callers may pass precomputed `indices` instead, which is how the tests
feed both sides the same hypotheses. `ransac_5pt_mono`, `ransac_3pt_arun`
and PnP are not ported yet.
"""

from __future__ import annotations

import torch


def _sample_indices(generator: torch.Generator, n_hyp: int, k: int, n: int, weights: torch.Tensor):
    """(n_hyp, k) correspondence indices drawn with replacement from the
    entries with weight 1 (uniformly among them); all-zero weights draw
    uniformly (those hypotheses score nothing)."""
    p = weights / torch.clamp(weights.sum(), min=1e-9)
    if not bool((p > 0).any()):
        p = torch.ones_like(p)
    idx = torch.multinomial(p, n_hyp * k, replacement=True, generator=generator)
    return idx.reshape(n_hyp, k)


def ransac_2pt_mono(
    f_ref: torch.Tensor,
    f_cur: torch.Tensor,
    mask: torch.Tensor,
    R_ref_cur: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    n_hyp: int = 256,
    threshold: float = 1e-6,
    indices: torch.Tensor | None = None,
):
    """Translation-only RANSAC given the rotation (2-point mono, the
    reference's ransac_use_2point_mono): each match constrains
    t . (f_ref x R f_cur) = 0. Returns (t_unit (3,), inliers (N,),
    n_inliers)."""
    n = f_ref.shape[0]
    Rf = torch.einsum("ij,nj->ni", R_ref_cur, f_cur)
    normals = torch.linalg.cross(f_ref, Rf)
    idx = indices if indices is not None else _sample_indices(
        generator, n_hyp, 2, n, mask.to(torch.float32)
    )
    n1 = normals[idx[:, 0]]
    n2 = normals[idx[:, 1]]
    t_hyp = torch.linalg.cross(n1, n2)
    t_norm = torch.linalg.norm(t_hyp, dim=-1, keepdim=True)
    t_hyp = t_hyp / torch.clamp(t_norm, min=1e-12)
    nn = normals / torch.clamp(torch.linalg.norm(normals, dim=-1, keepdim=True), min=1e-12)
    res = torch.einsum("hi,ni->hn", t_hyp, nn) ** 2
    inl = (res < threshold) & mask[None, :]
    scores = inl.sum(-1)
    best = torch.argmax(scores)
    t_best = t_hyp[best]
    inliers = inl[best]
    w = inliers.to(f_ref.dtype)
    Mmat = torch.einsum("n,ni,nj->ij", w, nn, nn)
    _, vecs = torch.linalg.eigh(Mmat)
    t_fit = vecs[:, 0]
    t_fit = t_fit * torch.sign(torch.sum(t_fit * t_best) + 1e-12)
    return t_fit, inliers, scores[best]


def stereo_point_cov_from_rect(fx, fy, cx, cy, baseline, uvd, pixel_sigma=1.0):
    """(..., 3, 3) covariance of backprojected stereo points under pixel
    noise on (uL, uR, v): J Sigma J^T with the analytic Jacobian."""
    uL, uR, v = uvd[..., 0], uvd[..., 1], uvd[..., 2]
    d = torch.clamp(uL - uR, min=1e-6)
    z = fx * baseline / d
    xl = uL - cx
    yl = v - cy
    dz_duL = -z / d
    dz_duR = z / d
    dx_duL = (z + xl * dz_duL) / fx
    dx_duR = xl * dz_duR / fx
    dx_dv = torch.zeros_like(z)
    dy_duL = yl * dz_duL / fy
    dy_duR = yl * dz_duR / fy
    dy_dv = z / fy
    dz_dv = torch.zeros_like(z)
    J = torch.stack(
        [
            torch.stack([dx_duL, dx_duR, dx_dv], -1),
            torch.stack([dy_duL, dy_duR, dy_dv], -1),
            torch.stack([dz_duL, dz_duR, dz_dv], -1),
        ],
        dim=-2,
    )
    return (pixel_sigma**2) * torch.einsum("...ij,...kj->...ik", J, J)


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-18, torch.full_like(det, 1e-18), det)
    inv = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), (b * f - c * e)], -1),
            torch.stack([B, (a * i - c * g), -(a * f - c * d)], -1),
            torch.stack([C, -(a * h - b * g), (a * e - b * d)], -1),
        ],
        dim=-2,
    )
    return inv / det[..., None, None]


def voting_1pt_stereo(
    p_ref, p_cur, cov_ref, cov_cur, mask, R_ref_cur, *, threshold: float = 6.2514
):
    """The reference's 1-point translation voting given the rotation
    (Tracker.cpp:393-620) as one [N,N] pass: pairwise Mahalanobis
    coherence of per-match translations, densest coherent row wins,
    information-weighted mean. Returns (t (3,), inliers (N,), n_inliers)."""
    Rp = torch.einsum("ij,nj->ni", R_ref_cur, p_cur)
    v = p_ref - Rp
    M = cov_ref + torch.einsum("ij,njk,lk->nil", R_ref_cur, cov_cur, R_ref_cur)
    dv = v[:, None, :] - v[None, :, :]
    S = M[:, None] + M[None, :]
    Sinv = _inv3(S)
    maha = torch.einsum("abi,abij,abj->ab", dv, Sinv, dv)
    pair_ok = mask[:, None] & mask[None, :]
    coherent = (maha < threshold) & pair_ok
    counts = coherent.sum(-1)
    counts = torch.where(mask, counts, torch.zeros_like(counts))
    best = torch.argmax(counts)
    inliers = coherent[best] & mask
    n_inl = counts[best]
    info = _inv3(M)
    w = inliers.to(v.dtype)
    total_info = torch.einsum("n,nij->ij", w, info)
    rhs = torch.einsum("n,nij,nj->i", w, info, v)
    t = torch.linalg.solve(total_info + 1e-9 * torch.eye(3, dtype=v.dtype, device=v.device), rhs)
    return t, inliers, n_inl
