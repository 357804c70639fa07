"""The port's legacy 15-channel ResNet and 1-D ResNet against the JAX package's.

Numpy-seeded weights in the JAX trees' shapes (``jax.eval_shape``) and
positive running statistics, carried into the port by
``from_jax_legacy_resnet_variables`` / ``from_jax_resnet1d_variables``; the
same numpy input through both, ``norm_kind='bn'`` on both sides. Eval mode,
and train mode with the updated running statistics, agree to 1e-4
relative to the largest value (float32; the train-mode batch statistics
of a ResNet-50 sum over few elements in another order). ResNet1d-101 is
held by shape: every tensor of the converted JAX tree against the port's,
and the head's width at the reference's 5000/5008-sample signal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_active_ai_tpu.models import resnet1d as j1d
from multimodal_active_ai_tpu.models import resnet_legacy as jlegacy
from multimodal_active_ai_tpu_torch.models import resnet1d as t1d
from multimodal_active_ai_tpu_torch.models import resnet_legacy as tlegacy
from multimodal_active_ai_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)
TOL = 1e-4

CASES = {
    "legacy18": (lambda: jlegacy.legacy_resnet18(norm_kind="bn", axis_name=None),
                 lambda: tlegacy.legacy_resnet18(norm_kind="bn"), (2, 20, 30, 15),
                 tckpt.from_jax_legacy_resnet_variables),
    "legacy50": (lambda: jlegacy.legacy_resnet50(norm_kind="bn", axis_name=None),
                 lambda: tlegacy.legacy_resnet50(norm_kind="bn"), (2, 12, 12, 15),
                 tckpt.from_jax_legacy_resnet_variables),
    "resnet1d_18": (lambda: j1d.resnet1d_18(), lambda: t1d.resnet1d_18(length=600), (2, 600, 1),
                    tckpt.from_jax_resnet1d_variables),
}


def _variables(jmodel, x, rng):
    shapes = jax.eval_shape(lambda k, a: jmodel.init(k, a, train=False), jax.random.PRNGKey(0),
                            jnp.asarray(x))
    params = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * (0.1 if len(s.shape) > 1 else 1.0)
                   ).astype(np.float32), shapes["params"])
    stats = jax.tree.map(lambda s: (np.abs(rng.standard_normal(s.shape)) + 0.5
                                    ).astype(np.float32), shapes["batch_stats"])
    return params, stats


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_in_eval_and_train_mode(name):
    make_j, make_t, shape, convert = CASES[name]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    jmodel, port = make_j(), make_t()
    params, stats = _variables(jmodel, x, rng)
    sd = convert(params, stats)
    assert sorted(sd) == sorted(port.state_dict())
    port.load_state_dict(sd)

    want = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    assert got.shape == want.shape and _rel(got, want) <= TOL

    want, new = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                             train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = port.train()(torch.from_numpy(x))
    assert _rel(got, want) <= TOL
    moved = convert(params, jax.device_get(new["batch_stats"]))
    now = port.state_dict()
    for k in moved:
        if k.endswith(("running_mean", "running_var")):
            assert _rel(now[k], moved[k]) <= TOL, k


def test_resnet1d_101_by_shape():
    """Every tensor of the converted JAX ResNet1d-101 has the port's shape,
    the output is ``(B, classes)``, and the first Dense reads 39 positions
    of 2048 channels at 5000 and 5008 samples (the reference's
    ``19968·expansion``)."""
    length = 1024
    jmodel = j1d.resnet1d_101()
    shapes = jax.eval_shape(lambda k, a: jmodel.init(k, a, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((1, length, 1)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = tckpt.from_jax_resnet1d_variables(zeros["params"], zeros["batch_stats"])
    port = t1d.resnet1d_101(length=length)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    with torch.no_grad():
        assert tuple(port.eval()(torch.randn(2, length, 1)).shape) == (2, 10)
    assert t1d.pooled_length(5000) == t1d.pooled_length(5008) == 39
    assert 39 * 512 * t1d.Bottleneck1d.expansion == 19968 * 4


def test_resnet1d_refuses_another_length():
    with pytest.raises(ValueError, match="built for 600"):
        t1d.resnet1d_18(length=600)(torch.zeros(1, 601, 1))
