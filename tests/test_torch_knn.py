"""The port's batched masked 1-NN (`ops/knn.nn1_batch`, the twin of
`csrc/knn.cu`) against `nn1_batch_pallas` in interpret mode.

Tolerance: squared distances to 1e-6 relative (both take the exact
difference form dx^2 + dy^2 + dz^2; XLA may contract one product into an
FMA); indices equal wherever the two nearest references are not within that
tolerance of each other, and exact duplicates go to the lowest index.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from perception_tpu.ops.pallas_knn import nn1_batch_pallas
from perception_tpu_torch import convert
from perception_tpu_torch.kernels import build
from perception_tpu_torch.ops import knn as pknn

T = convert.tensor


def _both(query, qvalid, ref, rvalid):
    jd, ji = nn1_batch_pallas(jnp.asarray(query), jnp.asarray(qvalid),
                              jnp.asarray(ref), jnp.asarray(rvalid),
                              interpret=True)
    pd, pi = pknn.nn1_batch(T(query), T(qvalid), T(ref), T(rvalid))
    return np.asarray(jd), np.asarray(ji), pd.numpy(), pi.numpy()


@pytest.mark.parametrize("n,p,s", [(3, 300, 700), (2, 50, 40), (4, 256, 256)])
def test_nn1_batch_matches_pallas(n, p, s):
    """Several query and reference tiles (P > 256, S > 256, ragged edges)."""
    rng = np.random.default_rng(p + s)
    query = rng.normal(0, 0.05, (n, p, 3)).astype(np.float32)
    query[..., 2] += 0.6
    ref = rng.normal(0, 0.05, (n, s, 3)).astype(np.float32)
    ref[..., 2] += 0.6
    qvalid = rng.random((n, p)) > 0.2
    rvalid = rng.random((n, s)) > 0.3
    jd, ji, pd, pi = _both(query, qvalid, ref, rvalid)
    assert pi.dtype == np.int32
    np.testing.assert_allclose(pd, jd, rtol=1e-6)
    d_all = ((query[:, :, None] - ref[:, None]) ** 2).sum(-1)
    d_all = np.where(rvalid[:, None], d_all, np.inf)
    two = np.sort(d_all, axis=-1)[..., :2]
    clear = two[..., 1] - two[..., 0] > 1e-6 * two[..., 1]
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(pi[clear], ji[clear])
    assert rvalid[np.arange(n)[:, None], pi].all()


def test_nn1_batch_ties_and_invalid_poses():
    """Duplicated references go to the lowest index; a pose with no valid
    reference gives (inf, 0), as the TPU kernel does."""
    rng = np.random.default_rng(1)
    ref = rng.normal(0, 0.05, (3, 40, 3)).astype(np.float32)
    ref[:, 20:] = ref[:, :20]                 # every point twice
    query = ref[:, :30] + rng.normal(0, 1e-3, (3, 30, 3)).astype(np.float32)
    rvalid = np.ones((3, 40), bool)
    rvalid[1] = False
    rvalid[2, :5] = False                     # the duplicates 20-24 win
    qvalid = np.ones((3, 30), bool)
    jd, ji, pd, pi = _both(query, qvalid, ref, rvalid)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pd, jd, rtol=1e-6)
    assert np.isinf(pd[1]).all() and (pi[1] == 0).all()
    assert (pi[0] < 20).all()
    assert ((pi[2] >= 5) & (pi[2] < 25)).all()


def test_nn1_batch_dispatch_and_kernel_checks():
    """CPU tensors run the twin (counted), the kernel wrapper refuses CPU
    tensors, and a pose set with no references is refused."""
    q = torch.zeros((1, 4, 3))
    r = torch.ones((1, 5, 3))
    rv = torch.ones((1, 5), dtype=torch.bool)
    build.reset_counts()
    d, i = pknn.nn1_batch(q, torch.ones((1, 4), dtype=torch.bool), r, rv)
    assert build.TWIN_CALLS["nn1_batch"] == 1
    assert sum(build.LAUNCHES.values()) == 0
    torch.testing.assert_close(d, torch.full((1, 4), 3.0))
    args, kw = pknn.prepare_inputs(q, None, r, rv)
    with pytest.raises(ValueError):
        pknn.launch_kernel(*args, **kw)
    with pytest.raises(ValueError):
        pknn.prepare_inputs(q, None, r[:, :0], rv[:, :0])
