"""The port's ANMS family (ops/anms.py, types 0-5) against the JAX
package's.

The candidate set is what `detect_features` hands the ANMS: the strongest
pixels of a seeded response (integer pixel coordinates, scores made with
numpy, a few exact score ties so that the tie rules show), with some
candidates masked out. The JAX functions run their greedy passes as a
`lax.scan` on the device; the port runs the same float32 decisions on the
host. Tolerance: none, the keep masks are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kimera_vio_tpu.ops import anms as janms
from kimera_vio_tpu_torch.ops import anms as tanms

W, H, M, K = 320, 240, 384, 64


def candidates(seed):
    rng = np.random.default_rng(seed)
    flat = rng.choice(W * H, M, replace=False)
    uv = np.stack([flat % W, flat // W], -1).astype(np.float32)
    score = rng.gamma(2.0, 1.0, M).astype(np.float32)
    score[10:20] = score[0]  # exact ties: the tie rules decide
    ok = rng.uniform(size=M) > 0.15
    return uv, score, ok


@pytest.mark.parametrize("anms_type", [0, 1, 2, 3, 4, 5])
def test_suppress_non_max_matches_jax(anms_type):
    uv, score, ok = candidates(anms_type)
    jkeep = janms.suppress_non_max(jnp.asarray(uv), jnp.asarray(score), jnp.asarray(ok), K,
                                   anms_type, W, H)
    tkeep = tanms.suppress_non_max(torch.from_numpy(uv), torch.from_numpy(score),
                                   torch.from_numpy(ok), K, anms_type, W, H)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert tkeep.dtype == torch.bool and 0 < int(tkeep.sum()) <= K
    assert not (tkeep.numpy() & ~ok).any()


@pytest.mark.parametrize("name", ["_greedy_disk_count", "_greedy_ssc_count"])
def test_greedy_pass_matches_jax_scan(name):
    """One greedy pass at a few radii: the host loop keeps what the JAX
    scan keeps, and counts the same."""
    uv, score, ok = candidates(11)
    s = np.where(ok, score, -np.inf).astype(np.float32)
    order = np.argsort(-s, kind="stable")
    uv_s, ok_s = uv[order], ok[order] & np.isfinite(s[order])
    make = tanms._greedy_disk if name == "_greedy_disk_count" else tanms._greedy_ssc
    run = make(uv_s, ok_s)
    for radius in (np.float32(3.5), np.float32(17.25), np.float32(60.0)):
        if name == "_greedy_disk_count":
            jkeep, jcount = janms._greedy_disk_count(jnp.asarray(uv_s), jnp.asarray(ok_s), radius)
        else:
            jkeep, jcount = janms._greedy_ssc_count(jnp.asarray(uv_s), jnp.asarray(ok_s), radius,
                                                    W, H)
        keep, count = run(radius)
        np.testing.assert_array_equal(keep, np.asarray(jkeep))
        assert count == int(jcount)


def test_unknown_type_raises():
    uv, score, ok = candidates(0)
    with pytest.raises(ValueError, match="unknown ANMS"):
        tanms.suppress_non_max(torch.from_numpy(uv), torch.from_numpy(score),
                               torch.from_numpy(ok), K, 6, W, H)
