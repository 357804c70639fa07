"""The PyTorch port's encoder, projector and NT-Xent against the JAX package's.

Weights cross from JAX through the port's ``from_jax_variables``; inputs
come from numpy seeds. Everything runs in float32 on the CPU, where the point
is the algorithm (the bf16 path is exercised on the card by chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_active_ai_tpu.models import SimCLRModule as JaxSimCLR
from multimodal_active_ai_tpu.objectives.ntxent import contrastive_loss as jax_loss
from multimodal_active_ai_tpu.utils.checkpoint import export_torch_simclr_state_dict
from multimodal_active_ai_tpu_torch.models import norm as tnorm
from multimodal_active_ai_tpu_torch.models.mlp import MLP, Identity, LogisticRegression
from multimodal_active_ai_tpu_torch.models.resnet import build_encoder, encoder_feature_dim
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
from multimodal_active_ai_tpu_torch.objectives.ntxent import contrastive_loss
from multimodal_active_ai_tpu_torch.utils.checkpoint import from_jax_variables

B = 4
# f32 convolutions through XLA and oneDNN sum in different orders; ten
# conv+BN layers keep the relative error near 1e-5 of the largest
# activation (~100-200 here), hence an absolute floor of 1e-3
FWD_TOL = dict(rtol=2e-4, atol=1e-3)


def _randomized_stats(batch_stats, seed=7):
    """Non-trivial running statistics, so eval mode tests them."""
    rng = np.random.default_rng(seed)

    def jitter(path, leaf):
        name = path[-1].key
        x = np.asarray(leaf)
        if name == "mean":
            return (rng.normal(0, 0.1, x.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(jitter, batch_stats)


@pytest.fixture(scope="module")
def resnet10():
    """JAX ResNet10 SimCLR variables, the port model loaded from them, and
    the JAX train/eval forwards on one glimpse batch."""
    model = JaxSimCLR(arch="ResNet10", axis_name=None, norm_kind="bn")
    x = np.random.default_rng(0).uniform(-50, 300, (B, 30, 30, 12)).astype(np.float32)
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = _randomized_stats(variables["batch_stats"])
    v = {"params": params, "batch_stats": stats}
    out_eval = jax.jit(functools.partial(model.apply, train=False))(v, x)
    out_train, mutated = jax.jit(functools.partial(
        model.apply, train=True, mutable=["batch_stats"]))(v, x)
    feats = jax.jit(functools.partial(model.apply, train=False,
                                      method=JaxSimCLR.features))(v, x)
    port = SimCLRModule(arch="ResNet10")
    port.load_state_dict(from_jax_variables(params, stats))
    return dict(params=params, stats=stats, x=x, port=port,
                out_eval=np.asarray(out_eval), out_train=np.asarray(out_train),
                new_stats=jax.tree.map(np.asarray, mutated["batch_stats"]),
                feats=np.asarray(feats))


# ---------------------------------------------------------------------------
# forward passes and BN statistics


def test_simclr_eval_forward_matches_jax(resnet10):
    port = resnet10["port"].eval()
    with torch.no_grad():
        out = port(torch.from_numpy(resnet10["x"]))
    assert out.shape == (B, 128) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), resnet10["out_eval"], **FWD_TOL)


def test_simclr_features_match_jax(resnet10):
    port = resnet10["port"].eval()
    with torch.no_grad():
        feats = port.features(torch.from_numpy(resnet10["x"]))
    assert feats.shape == (B, 4, 4, encoder_feature_dim("ResNet10"))
    np.testing.assert_allclose(feats.numpy(), resnet10["feats"], **FWD_TOL)


def test_simclr_train_forward_and_running_stats_match_jax(resnet10):
    port = SimCLRModule(arch="ResNet10")
    port.load_state_dict(from_jax_variables(resnet10["params"], resnet10["stats"]))
    port.train()
    with torch.no_grad():
        out = port(torch.from_numpy(resnet10["x"]))
    np.testing.assert_allclose(out.numpy(), resnet10["out_train"], **FWD_TOL)
    # flax semantics: r <- 0.9 r + 0.1 batch, with the biased variance
    want = from_jax_variables(resnet10["params"], resnet10["new_stats"])
    got = port.state_dict()
    stat_keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stat_keys) == 2 * 12
    for k in stat_keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert int(got["f.bn1.num_batches_tracked"]) == 1


def test_batchnorm_differs_from_torch_running_var_on_purpose():
    """The running variance takes the biased batch variance (flax), where
    torch.nn.BatchNorm2d takes the unbiased one."""
    x = torch.from_numpy(np.random.default_rng(1).normal(2, 3, (6, 5, 4, 4)).astype(np.float32))
    bn = tnorm.BatchNorm(5).train()
    y = bn(x)
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean(dim=(0, 2, 3)))
    ref = torch.nn.functional.batch_norm(x, None, None, training=True, eps=1e-5)
    torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-4)
    # sync_bn (the global batch's statistics) is bn on one process, bit for bit
    sync = tnorm.make_norm("sync_bn")(5).train()
    assert torch.equal(sync(x), y)
    assert torch.equal(sync.running_var, bn.running_var)
    assert torch.equal(sync.running_mean, bn.running_mean)


def test_bf16_forward_keeps_f32_parameters_and_output(resnet10):
    port = SimCLRModule(arch="ResNet10", dtype=torch.bfloat16)
    port.load_state_dict(from_jax_variables(resnet10["params"], resnet10["stats"]))
    port.eval()
    with torch.no_grad():
        out = port(torch.from_numpy(resnet10["x"]))
    assert out.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in port.parameters())
    # bf16 products (2^-8 relative) through ten layers: errors of ~1% of
    # the output's scale, bounded here at 3%
    ref = resnet10["out_eval"]
    assert np.abs(out.numpy() - ref).max() <= 0.03 * np.abs(ref).max()


def test_heads():
    x = torch.randn(3, 4, 4, 8)
    mlp = MLP(128, 16, 5, generator=torch.Generator().manual_seed(0))
    assert [k for k in mlp.state_dict()] == ["layers.0.weight", "layers.0.bias",
                                             "layers.2.weight", "layers.2.bias"]
    # C-major flatten of the NHWC map, as the reference torch module sees NCHW
    ref = mlp.layers(x.permute(0, 3, 1, 2).reshape(3, -1))
    torch.testing.assert_close(mlp(x), ref)
    lr = LogisticRegression(128, 10)
    assert lr(x).shape == (3, 10)
    assert Identity()(x) is x


# ---------------------------------------------------------------------------
# weights carried across


def _shape_variables(arch):
    """Random numpy variables with the JAX model's tree and shapes (no
    JAX init run: eval_shape gives the tree)."""
    model = JaxSimCLR(arch=arch, axis_name=None, norm_kind="bn")
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.PRNGKey(0), jnp.ones((2, 30, 30, 12)))
    rng = np.random.default_rng(3)
    fill = lambda s: rng.normal(0, 1, s.shape).astype(np.float32)  # noqa: E731
    return (jax.tree.map(fill, shapes["params"]),
            jax.tree.map(fill, shapes["batch_stats"]))


@pytest.mark.parametrize("arch", ["ResNet10", "ResNet18", "ResNet50"])
def test_from_jax_variables_matches_the_jax_exporter(arch):
    params, stats = _shape_variables(arch)
    ref = export_torch_simclr_state_dict(params, stats)
    got = from_jax_variables(params, stats)
    assert list(got) == list(ref)
    for k, v in ref.items():
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # and it is exactly the port model's state_dict layout
    port_sd = SimCLRModule(arch=arch).state_dict()
    assert sorted(port_sd) == sorted(got)
    for k, v in port_sd.items():
        assert tuple(v.shape) == tuple(got[k].shape), k


def test_encoder_archs_and_output_shapes():
    x = torch.randn(2, 30, 30, 12)
    for arch, dim in [("ResNet10", 512), ("ResNet34", 512), ("ResNet50", 2048)]:
        enc = build_encoder(arch).eval()
        with torch.no_grad():
            assert enc(x).shape == (2, 4, 4, dim)
        assert encoder_feature_dim(arch) == dim
    with pytest.raises(ValueError, match="Unrecognized"):
        build_encoder("ResNet9")


# ---------------------------------------------------------------------------
# NT-Xent


@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("temperature", [0.05, 0.5])
def test_contrastive_loss_and_gradient_match_jax(gather, temperature):
    rng = np.random.default_rng(5)
    h1 = rng.normal(0, 1, (8, 16)).astype(np.float32)
    h2 = rng.normal(0, 1, (8, 16)).astype(np.float32)

    def jf(a, b):
        return jax_loss(a, b, temperature=temperature, torch_gather_semantics=gather)[0]

    ref_loss, ref_logits, ref_labels = jax_loss(
        h1, h2, temperature=temperature, torch_gather_semantics=gather)
    ref_g1, ref_g2 = jax.grad(jf, argnums=(0, 1))(h1, h2)

    t1 = torch.from_numpy(h1).requires_grad_()
    t2 = torch.from_numpy(h2).requires_grad_()
    loss, logits, labels = contrastive_loss(t1, t2, temperature=temperature,
                                            torch_gather_semantics=gather)
    loss.backward()
    # f32 softmax over 16 logits scaled by 1/T = 20: relative error ~1e-6
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(ref_logits),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))
    np.testing.assert_allclose(t2.grad.numpy(), np.asarray(ref_g2), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(ref_g1), rtol=1e-4, atol=1e-6)
