"""Batched geometric verification: the RANSAC family.

Port of kimera_vio_tpu/ops/ransac.py: every hypothesis of a fixed batch
is scored against every correspondence at once. Solvers: 2-pt mono given
the rotation, 5-pt mono (batched 8-point essential + cheirality), 1-pt
stereo voting given the rotation, 3-pt Arun 3D-3D, linear 6-pt PnP; and
the loop-pose refinements (Huber IRLS Arun, reprojection Gauss-Newton
PnP). Hypothesis samples come from a `torch.Generator` (the reference
draws them with `jax.random.choice`, a stream torch cannot reproduce);
callers may pass precomputed `indices` instead, which is how the tests
feed both sides the same hypotheses. `vmap` over hypotheses becomes a
leading batch axis.
"""

from __future__ import annotations

import torch

from kimera_vio_tpu_torch.common import geometry as geo

# The 2-pt mono solver's bound on |n1 x n2| / (|n1| |n2|), the sine
# between a hypothesis' two normals, below which it scores nothing.
PARALLEL_EPS = 1e-5


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
    t . n = 0 with n = f_ref x R f_cur, and two matches give the
    hypothesis t = n1 x n2. Returns (t_unit (3,), inliers (N,),
    n_inliers).

    A hypothesis is degenerate, and scores no inliers, where its two
    indices are equal or its two normals are parallel to working
    precision, |n1 x n2| <= PARALLEL_EPS |n1| |n2|. Its t is then
    rounding noise: unit length in a noise direction above the 1e-12
    clamp, and below it (|n| under about 1e-2) a short vector whose squared
    residuals shrink with it, so that it passes far more matches than a
    proper hypothesis. The test is scale-free because |n| is the track's
    parallax sine (1e-4 to 1e-1): an absolute bound would reject proper
    hypotheses at low parallax. PARALLEL_EPS sits above the float32 noise
    of the cross product (a few 1e-7 of |n1| |n2|) and far below the
    angle between the normals of two distinct landmarks. When every
    hypothesis is degenerate (one valid match) no match is an inlier.

    The JAX package has no such guard (kimera_vio_tpu/ops/ransac.py:40-43
    says repeated draws "score poorly and lose"; :85-90 builds and clamps
    t): there a repeated draw can win, its direction differing between
    the packages; tests/test_torch_mono_ransac.py names the divergence."""
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
    n_norm = torch.linalg.norm(normals, dim=-1)
    degenerate = (idx[:, 0] == idx[:, 1]) | (
        t_norm[:, 0] <= PARALLEL_EPS * n_norm[idx[:, 0]] * n_norm[idx[:, 1]])
    t_hyp = t_hyp / torch.clamp(t_norm, min=1e-12)
    nn = normals / torch.clamp(n_norm[:, None], min=1e-12)
    res = torch.einsum("hi,ni->hn", t_hyp, nn) ** 2
    inl = (res < threshold) & mask[None, :] & ~degenerate[:, None]
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


def _epipolar_residual_sq(E: torch.Tensor, f_ref: torch.Tensor, f_cur: torch.Tensor):
    """Squared normalized epipolar residual (f_ref^T E f_cur)^2 /
    (|E f_cur|^2 + |E^T f_ref|^2) of every match under every hypothesis:
    E (H,3,3) -> (H,N)."""
    Ef2 = torch.einsum("hij,nj->hni", E, f_cur)
    Etf1 = torch.einsum("hji,nj->hni", E, f_ref)
    num = torch.einsum("ni,hni->hn", f_ref, Ef2) ** 2
    den = torch.sum(Ef2**2, -1) + torch.sum(Etf1**2, -1)
    return num / torch.clamp(den, min=1e-12)


def _essential_from_8pt(f_ref: torch.Tensor, f_cur: torch.Tensor, w=None):
    """Essential matrices from bearing pairs (..., n, 3), one per leading
    index: the null vector of A^T A (A rows = f_ref f_cur^T, row-major E),
    projected onto the essential manifold (singular values 1, 1, 0).
    `w` (..., n) weights the rows of A (the inlier refit)."""
    a = f_ref if w is None else f_ref * w[..., None]
    A = torch.einsum("...ni,...nj->...nij", a, f_cur).flatten(-2)
    M = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(M)
    E = vecs[..., :, 0].unflatten(-1, (3, 3))
    U, _, Vt = torch.linalg.svd(E)
    s_proj = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return U @ torch.diag_embed(s_proj.expand(U.shape[:-1])) @ Vt


def decompose_essential(E: torch.Tensor, f_ref: torch.Tensor, f_cur: torch.Tensor,
                        mask: torch.Tensor):
    """E -> (R_ref_cur, t_unit): the candidate of the four decompositions
    with the most matches in front of both cameras (midpoint depths)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([t, -t, t, -t])
    # Per candidate and match: least-squares scales a, b of
    # a f_ref ~ b R f_cur + t.
    Rf = torch.einsum("cij,nj->cni", Rs, f_cur)
    f11 = torch.sum(f_ref * f_ref, -1)[None]
    f12 = -torch.sum(f_ref[None] * Rf, -1)
    f22 = torch.sum(Rf * Rf, -1)
    b1 = torch.einsum("ni,ci->cn", f_ref, ts)
    b2 = -torch.sum(Rf * ts[:, None, :], -1)
    det = f11 * f22 - f12 * f12
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    a = (f22 * b1 - f12 * b2) / det
    b = (f11 * b2 - f12 * b1) / det
    scores = ((a > 0) & (b > 0) & mask[None]).sum(-1)
    k = torch.argmax(scores)
    return Rs[k], ts[k]


def ransac_5pt_mono(
    f_ref: torch.Tensor,
    f_cur: torch.Tensor,
    mask: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    n_hyp: int = 128,
    threshold: float = 1e-6,
    indices: torch.Tensor | None = None,
):
    """Essential-matrix RANSAC (the reference's Nister 5-pt role) as
    batched 8-point hypotheses, refit on the best inlier set. Returns
    (R_ref_cur, t_unit, inliers (N,), n_inliers)."""
    n = f_ref.shape[0]
    idx = indices if indices is not None else _sample_indices(
        generator, n_hyp, 8, n, mask.to(torch.float32)
    )
    E_hyp = _essential_from_8pt(f_ref[idx], f_cur[idx])
    res = _epipolar_residual_sq(E_hyp, f_ref, f_cur)
    inl = (res < threshold) & mask[None, :]
    scores = inl.sum(-1)
    best = torch.argmax(scores)
    inliers = inl[best]
    E = _essential_from_8pt(f_ref, f_cur, inliers.to(f_ref.dtype))
    R, t = decompose_essential(E, f_ref, f_cur, inliers)
    return R, t, inliers, scores[best]


def _arun(p_ref: torch.Tensor, p_cur: torch.Tensor, w: torch.Tensor):
    """Weighted closed-form 3D-3D alignment (Arun/Umeyama, no scale) of
    (..., n, 3) point sets with weights (..., n): (R, t) with
    p_ref ~ R p_cur + t."""
    wsum = torch.clamp(w.sum(-1), min=1e-9)
    mu_r = torch.einsum("...n,...ni->...i", w, p_ref) / wsum[..., None]
    mu_c = torch.einsum("...n,...ni->...i", w, p_cur) / wsum[..., None]
    X = p_cur - mu_c[..., None, :]
    Y = p_ref - mu_r[..., None, :]
    H = torch.einsum("...n,...ni,...nj->...ij", w, X, Y)
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ Ut))
    ones = torch.ones_like(d)
    D = torch.diag_embed(torch.stack([ones, ones, d], -1))
    R = V @ D @ Ut
    t = mu_r - (R @ mu_c[..., None])[..., 0]
    return R, t


def ransac_3pt_arun(
    p_ref: torch.Tensor,
    p_cur: torch.Tensor,
    mask: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    n_hyp: int = 128,
    threshold: float = 0.1,
    indices: torch.Tensor | None = None,
):
    """3-point Arun 3D-3D RANSAC (reference Tracker.cpp:667-742), refit on
    the best inlier set. Returns (R_ref_cur, t, inliers (N,), n_inliers)."""
    n = p_ref.shape[0]
    idx = indices if indices is not None else _sample_indices(
        generator, n_hyp, 3, n, mask.to(torch.float32)
    )
    w3 = torch.ones(idx.shape, dtype=p_ref.dtype, device=p_ref.device)
    Rs, ts = _arun(p_ref[idx], p_cur[idx], w3)
    pred = torch.einsum("hij,nj->hni", Rs, p_cur) + ts[:, None, :]
    res = torch.linalg.norm(pred - p_ref[None], dim=-1)
    inl = (res < threshold) & mask[None, :]
    scores = inl.sum(-1)
    best = torch.argmax(scores)
    inliers = inl[best]
    R, t = _arun(p_ref, p_cur, inliers.to(p_ref.dtype))
    return R, t, inliers, scores[best]


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


# ---------------------------------------------------------------------------
# PnP (2D-3D)
# ---------------------------------------------------------------------------


def _dlt_pnp(p_world: torch.Tensor, f_bearing: torch.Tensor, w: torch.Tensor):
    """Linear PnP from >= 6 world-point / bearing pairs (..., n, 3) with
    weights (..., n): the null vector of the cross-product constraint
    f x (R p + t) = 0 (unknowns: the columns of R, then t), R projected
    onto SO(3); of the null vector's two signs the one with more points
    in front of the camera. Returns (R, t), x_cam = R x_world + t."""
    fx_hat = geo.hat(f_bearing)  # (..., n, 3, 3)
    p = p_world
    A = torch.cat([fx_hat * p[..., 0:1, None], fx_hat * p[..., 1:2, None],
                   fx_hat * p[..., 2:3, None], fx_hat], dim=-1)  # (..., n, 3, 12)
    A = (A * w[..., None, None]).flatten(-3, -2)
    M = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(M)
    vec = vecs[..., :, 0]

    def build(vec):
        R_est = torch.stack([vec[..., 0:3], vec[..., 3:6], vec[..., 6:9]], dim=-1)
        t_est = vec[..., 9:12]
        U, s, Vt = torch.linalg.svd(R_est)
        scale = torch.clamp(torch.mean(s, -1), min=1e-12)
        det = torch.linalg.det(U @ Vt)
        ones = torch.ones_like(det)
        R = U @ torch.diag_embed(torch.stack([ones, ones, det], -1)) @ Vt
        t = t_est / scale[..., None]
        cam = torch.einsum("...ij,...nj->...ni", R, p_world) + t[..., None, :]
        depth = torch.sum(cam * f_bearing, -1)
        score = torch.sum(torch.where(w > 0, (depth > 0).to(vec.dtype), torch.zeros_like(depth)), -1)
        return R, t, score

    R_p, t_p, s_p = build(vec)
    R_m, t_m, s_m = build(-vec)
    pick = s_p >= s_m
    return (torch.where(pick[..., None, None], R_p, R_m),
            torch.where(pick[..., None], t_p, t_m))


def ransac_pnp(
    p_world: torch.Tensor,
    f_bearing: torch.Tensor,
    mask: torch.Tensor,
    generator: torch.Generator | None = None,
    *,
    n_hyp: int = 128,
    threshold: float = 1.0,
    focal: float = 450.0,
    indices: torch.Tensor | None = None,
):
    """Batched linear-PnP RANSAC (reference PnP tracking,
    Tracker.cpp:1163-1270): angular residual scaled by the focal length
    (~ pixels). Returns (R_cw, t_cw, inliers (N,), n_inliers) with
    x_cam = R_cw x_world + t_cw."""
    n = p_world.shape[0]
    idx = indices if indices is not None else _sample_indices(
        generator, n_hyp, 6, n, mask.to(torch.float32)
    )
    w6 = torch.ones(idx.shape, dtype=p_world.dtype, device=p_world.device)
    Rs, ts = _dlt_pnp(p_world[idx], f_bearing[idx], w6)
    pred = torch.einsum("hij,nj->hni", Rs, p_world) + ts[:, None, :]
    pred_n = pred / torch.clamp(torch.linalg.norm(pred, dim=-1, keepdim=True), min=1e-12)
    cos = torch.clamp(torch.einsum("hni,ni->hn", pred_n, f_bearing), -1.0, 1.0)
    res_px = focal * torch.sqrt(torch.clamp(1.0 - cos**2, min=0.0))
    inl = (res_px < threshold) & mask[None, :] & (cos > 0)
    scores = inl.sum(-1)
    best = torch.argmax(scores)
    inliers = inl[best]
    R, t = _dlt_pnp(p_world, f_bearing, inliers.to(p_world.dtype))
    return R, t, inliers, scores[best]


# ---------------------------------------------------------------------------
# Loop-pose refinement (the reference's refinePoses,
# LoopClosureDetector.cpp:979): fixed-iteration IRLS / Gauss-Newton.
# ---------------------------------------------------------------------------


def refine_arun_huber(p_ref, p_cur, inliers, R0, t0, *, huber_m: float = 0.10, iters: int = 5):
    """Robust 3D-3D loop-pose refinement: `iters` Huber-weighted Arun
    alignments over the RANSAC inliers (residual ||p_ref - (R p_cur + t)||)."""
    base_w = inliers.to(p_ref.dtype)
    R, t = R0, t0
    for _ in range(iters):
        res = torch.linalg.norm(p_ref - (p_cur @ R.T + t), dim=-1)
        w = base_w * torch.clamp(huber_m / torch.clamp(res, min=1e-12), max=1.0)
        R, t = _arun(p_ref, p_cur, w)
    return R, t


def refine_pnp_gn(p_world, f_bearing, inliers, R0, t0, *, focal: float = 450.0,
                  huber_px: float = 3.0, iters: int = 8):
    """Reprojection Gauss-Newton refinement of a PnP pose: `iters` steps of
    the Huber-weighted bearing residual focal * (normalize(R x + t) - b)
    over a 6-dof twist (left rotation perturbation, translation delta),
    Jacobian by forward-mode autodiff as in the reference."""
    base_w = inliers.to(p_world.dtype)
    eye6 = torch.eye(6, dtype=p_world.dtype, device=p_world.device)

    def residual(params, R, t):
        Rp = geo.so3_exp(params[:3]) @ R
        pred = p_world @ Rp.T + (t + params[3:])
        pred_n = pred / torch.clamp(torch.linalg.norm(pred, dim=-1, keepdim=True), min=1e-12)
        return focal * (pred_n - f_bearing).reshape(-1)

    R, t = R0, t0
    z6 = torch.zeros(6, dtype=p_world.dtype, device=p_world.device)
    for _ in range(iters):
        r = residual(z6, R, t)
        rn = torch.linalg.norm(r.reshape(-1, 3), dim=-1)
        w = base_w * torch.clamp(huber_px / torch.clamp(rn, min=1e-12), max=1.0)
        w3 = torch.repeat_interleave(w, 3)
        J = torch.func.jacfwd(residual)(z6, R, t)
        H = J.T @ (J * w3[:, None]) + 1e-6 * eye6
        g = J.T @ (r * w3)
        dx = -torch.linalg.solve(H, g)
        R, t = geo.so3_exp(dx[:3]) @ R, t + dx[3:]
    return R, t
