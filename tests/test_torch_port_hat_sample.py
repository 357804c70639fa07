"""The port's one-level hat sampler against the JAX package's.

``hat_sample_plain`` (the CPU path of ``hat_sample``, whose CUDA kernel
chip_smoke.py holds against it on the card) against ``hat_sample_xla`` and
the Pallas kernel ``hat_sample`` in interpret mode, on the three cases of
tests/test_pallas_retina.py, with numpy-seeded inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_active_ai_tpu.ops import pallas_retina as jpr
from multimodal_active_ai_tpu_torch.ops import glimpse_sample as tgs

# the same algorithm and the same bf16 y weights; f32 sums in another order
PLAIN_TOL = dict(rtol=1e-5, atol=2e-3)
# the tolerance of tests/test_pallas_retina.py for the Pallas kernel
PALLAS_TOL = dict(rtol=1e-2, atol=1e-1)


def _case(seed, b=3, m=32, p=20, win=16, edge=False):
    rng = np.random.default_rng(seed)
    mip = jnp.asarray(rng.uniform(0, 255, (b, m, 3 * m)), jnp.bfloat16)
    start = rng.integers(0, m - win, (b, 2)).astype(np.int32)
    start[:, 0] = start[:, 0] // 8 * 8         # the Pallas kernel's y alignment
    rel = (rng.uniform(0, 1, (b, p, 2)) * (win - 1)).astype(np.float32)
    if edge:                                    # past both window edges
        rel[:, 0] = -5.0
        rel[:, 1] = win + 9.0
    return mip, rel, start, win


CASES = {"matches_xla": dict(seed=0), "edge_clamp": dict(seed=1, p=8, edge=True),
         "p_not_multiple_of_8": dict(seed=2, p=13)}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    mip, rel, start, win = _case(**CASES[request.param])
    j_args = (mip, jnp.asarray(rel), jnp.asarray(start), win)
    xla = np.asarray(jpr.hat_sample_xla(*j_args))
    pallas = np.asarray(jpr.hat_sample(*j_args, interpret=True))
    t_mip = torch.from_numpy(np.array(mip.astype(jnp.float32))).to(torch.bfloat16)
    t_args = (t_mip, torch.from_numpy(rel), torch.from_numpy(start), win)
    return request.param, tgs.hat_sample_plain(*t_args), tgs.hat_sample(*t_args), xla, pallas


def test_hat_sample_plain_matches_xla(case):
    name, plain, _, xla, _ = case
    assert plain.shape == xla.shape and plain.dtype == torch.float32
    np.testing.assert_allclose(plain.numpy(), xla, **PLAIN_TOL, err_msg=name)


def test_hat_sample_plain_matches_pallas_interpret(case):
    name, plain, _, _, pallas = case
    assert plain.shape == pallas.shape
    np.testing.assert_allclose(plain.numpy(), pallas, **PALLAS_TOL, err_msg=name)


def test_hat_sample_wrapper_takes_plain_version_on_cpu(case):
    _, plain, wrapped, _, _ = case
    assert torch.equal(wrapped, plain)


def test_hat_sample_rejects_bad_geometry():
    mip = torch.zeros((2, 16, 48), dtype=torch.bfloat16)
    rel = torch.zeros((2, 5, 2))
    start = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="window"):
        tgs.hat_sample(mip, rel, start, 17)
    with pytest.raises(ValueError, match="rel"):
        tgs.hat_sample(mip, rel[:1], start, 8)
    with pytest.raises(ValueError, match="mip"):
        tgs.hat_sample(mip[..., :40], rel, start, 8)
