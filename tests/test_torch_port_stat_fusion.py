"""The port's fused BatchNorm statistics against the JAX package's.

Covered: ``stat_sums``/``batch_mean_var`` (B2's plain path) against
``pallas_bn`` in interpret mode, ``FusedStatsBatchNorm``, ``conv1x1_stats``
(B3's plain path) and ``gram_stats`` against ``pallas_conv_bn``, the fused
1×1 conv + BN against ``FusedConv1x1BN``, a stride-2 downsampling
Bottleneck with ``stat_fusion``, and ``from_jax_variables`` on the fused
JAX layout. Inputs come from numpy seeds; everything runs on the CPU, where
the port's wrappers take their plain versions (the CUDA kernels are held
against those by chip_smoke.py on the card).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_active_ai_tpu.models import SimCLRModule as JaxSimCLR
from multimodal_active_ai_tpu.models.conv_bn import FusedConv1x1BN, convert_stat_fusion_variables
from multimodal_active_ai_tpu.models.norm import FusedStatsBatchNorm as JaxFusedBN
from multimodal_active_ai_tpu.models.norm import make_norm as jax_make_norm
from multimodal_active_ai_tpu.models.resnet import Bottleneck as JaxBottleneck
from multimodal_active_ai_tpu.ops import pallas_bn, pallas_conv_bn
from multimodal_active_ai_tpu_torch.models import conv_bn as tconv_bn
from multimodal_active_ai_tpu_torch.models.norm import BatchNorm, FusedStatsBatchNorm, make_norm
from multimodal_active_ai_tpu_torch.models.resnet import Bottleneck, build_encoder
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
from multimodal_active_ai_tpu_torch.ops import conv1x1_stats as tcs
from multimodal_active_ai_tpu_torch.ops import stat_sums as tss
from multimodal_active_ai_tpu_torch.utils.checkpoint import from_jax_variables

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# f32 sums of a few hundred values of magnitude <= 4, taken in another
# order: relative error ~1e-6, absolute ~1e-4 at worst
SUM_TOL = dict(rtol=1e-5, atol=1e-3)
# one module, f32: only summation order separates the two sides
MODULE_TOL = dict(rtol=1e-4, atol=1e-4)
# gradients through BatchNorm's normalisation: a few f32 roundings more
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _both(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(a).astype(jd)
    return j, _t(np.asarray(j.astype(jnp.float32))).to(td)


# ---------------------------------------------------------------------------
# B2: stat_sums and batch_mean_var


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(96, 64), (256, 128), (40, 24)])
def test_stat_sums_and_gradient_match_jax(shape, dtype):
    r = np.random.default_rng(sum(shape))
    jx, tx = _both(r.uniform(-2, 2, shape).astype(np.float32), dtype)
    cot = r.uniform(-1, 1, (2, shape[1])).astype(np.float32)

    js, jsq = pallas_bn.stat_sums(jx, True)
    jm, jv = pallas_bn.batch_mean_var(jx, True)
    tx.requires_grad_()
    ts, tsq = tss.stat_sums(tx)
    assert ts.dtype == tsq.dtype == torch.float32
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), **SUM_TOL)
    np.testing.assert_allclose(tsq.detach().numpy(), np.asarray(jsq), **SUM_TOL)
    tm, tv = tss.batch_mean_var(tx.detach())
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)

    # dx = dΣ + 2·x·dΣ², cast to x's type: the same f32 arithmetic on both
    # sides (bf16 results may sit one rounding step apart)
    def f(x):
        s, sq = pallas_bn.stat_sums(x, True)
        return jnp.sum(s * cot[0]) + jnp.sum(sq * cot[1])

    jg = np.asarray(jax.grad(f)(jx).astype(jnp.float32))
    (ts * _t(cot[0])).sum().add((tsq * _t(cot[1])).sum()).backward()
    assert tx.grad.dtype == tx.dtype
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "f32" else dict(rtol=2**-7, atol=0)
    np.testing.assert_allclose(tx.grad.float().numpy(), jg, **tol)


def test_stat_sums_wrapper_takes_plain_version_on_cpu():
    x = _t(np.random.default_rng(0).normal(0, 1, (40, 24)))
    before = tss.stat_sums.launches
    got = tss.stat_sums(x)
    want = tss.stat_sums_plain(x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tss.stat_sums.launches == before


def test_fused_stats_batchnorm_matches_jax():
    """Train output, running statistics, eval output and gradients (scale,
    bias, x) against the JAX ``FusedStatsBatchNorm``; same state as the
    port's ``BatchNorm``."""
    r = np.random.default_rng(3)
    x = r.uniform(-3, 3, (8, 5, 5, 16)).astype(np.float32)
    t = r.uniform(-1, 1, x.shape).astype(np.float32)
    v = {"params": {"scale": r.uniform(0.5, 1.5, 16).astype(np.float32),
                    "bias": r.normal(0, 0.2, 16).astype(np.float32)},
         "batch_stats": {"mean": r.normal(0, 0.1, 16).astype(np.float32),
                         "var": r.uniform(0.5, 1.5, 16).astype(np.float32)}}
    mod = JaxFusedBN(use_running_average=None, momentum=0.9, epsilon=1e-5)

    def loss(params, xi):
        y, _ = mod.apply({"params": params, "batch_stats": v["batch_stats"]}, xi,
                         use_running_average=False, mutable=["batch_stats"])
        return jnp.mean((y - t) ** 2)

    jy, jmut = mod.apply(v, x, use_running_average=False, mutable=["batch_stats"])
    jeval = mod.apply({"params": v["params"], "batch_stats": jmut["batch_stats"]}, x,
                      use_running_average=True)
    jgp, jgx = jax.grad(loss, (0, 1))(v["params"], x)

    bn = make_norm("bn_fused")(16)
    assert isinstance(bn, FusedStatsBatchNorm)
    assert list(bn.state_dict()) == list(BatchNorm(16).state_dict())
    with torch.no_grad():
        bn.weight.copy_(_t(v["params"]["scale"]))
        bn.bias.copy_(_t(v["params"]["bias"]))
        bn.running_mean.copy_(_t(v["batch_stats"]["mean"]))
        bn.running_var.copy_(_t(v["batch_stats"]["var"]))
    tx = _t(x).requires_grad_()
    ty = bn.train()(tx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **MODULE_TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(jmut["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(jmut["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    assert int(bn.num_batches_tracked) == 1
    ((ty - _t(t)) ** 2).mean().backward()
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(jgp["scale"]), **GRAD_TOL)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(jgp["bias"]), **GRAD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    with torch.no_grad():
        te = bn.eval()(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(te.numpy(), np.asarray(jeval), **MODULE_TOL)


# ---------------------------------------------------------------------------
# B3: conv1x1_stats and gram_stats


def _jax_stats_fn(impl):
    if impl == "pallas":
        return lambda x, w: pallas_conv_bn.conv1x1_stats(x, w, True)
    return pallas_conv_bn.gram_stats


@pytest.mark.parametrize("impl", ["pallas", "gram"])
@pytest.mark.parametrize("mkn", [(64, 16, 64), (96, 24, 40), (256, 64, 256)])
def test_stats_product_and_gradients_match_jax(mkn, impl):
    """``(y, Σy, Σy²)`` and the gradients of x and w with nonzero
    cotangents on all three outputs. The port takes w as the conv's
    ``(N, K)``, the JAX package as ``(K, N)``."""
    m, k, n = mkn
    r = np.random.default_rng(m + k + n)
    x = r.uniform(-1, 1, (m, k)).astype(np.float32)
    w = r.uniform(-1, 1, (k, n)).astype(np.float32)
    ty = r.uniform(-1, 1, (m, n)).astype(np.float32)
    ts = r.uniform(-1, 1, (n,)).astype(np.float32)
    jfn = _jax_stats_fn(impl)

    def jloss(x, w):
        y, s, sq = jfn(x, w)
        return jnp.sum(y * ty) + jnp.sum(s * ts) + 0.5 * jnp.sum(sq * ts)

    jy, js, jsq = jfn(x, w)
    jgx, jgw = jax.grad(jloss, (0, 1))(x, w)

    tx = _t(x).requires_grad_()
    tw = _t(w.T).contiguous().requires_grad_()
    fn = tcs.conv1x1_stats if impl == "pallas" else tcs.gram_stats
    y, s, sq = fn(tx, tw)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    # Σy² of the gram form comes from wᵀ(xᵀx)w: rounding grows with K
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(sq.detach().numpy(), np.asarray(jsq), rtol=1e-4, atol=1e-3)
    ((y * _t(ty)).sum() + (s * _t(ts)).sum() + 0.5 * (sq * _t(ts)).sum()).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw).T, rtol=1e-4, atol=1e-4)
    if impl == "pallas":
        py, ps, psq = tcs.conv1x1_stats_plain(_t(x), tw.detach())
        assert torch.equal(py, y.detach()) and torch.equal(ps, s.detach())


def test_stats_product_bf16_takes_statistics_before_rounding():
    """bf16 operands: ``y`` is rounded to bf16, the statistics are the
    float32 sums of the unrounded product (as the TPU kernel's epilogue)."""
    r = np.random.default_rng(9)
    jx, tx = _both(r.uniform(-1, 1, (64, 32)).astype(np.float32), "bf16")
    jw, tw = _both(r.uniform(-1, 1, (32, 48)).astype(np.float32), "bf16")
    jy, js, jsq = pallas_conv_bn.conv1x1_stats(jx, jw, True)
    y, s, sq = tcs.conv1x1_stats_plain(tx, tw.t().contiguous())
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    # y: one bf16 rounding of nearly equal f32 values (at most one step apart)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy.astype(jnp.float32)),
                               rtol=2**-7, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **SUM_TOL)
    np.testing.assert_allclose(sq.numpy(), np.asarray(jsq), **SUM_TOL)
    y32 = tx.float() @ tw.float()
    assert not torch.allclose(sq, (y.float() ** 2).sum(0), rtol=1e-6, atol=0)
    torch.testing.assert_close(sq, (y32 * y32).sum(0))


# ---------------------------------------------------------------------------
# the fused 1x1 conv + BN


def _port_pair(kernel, stride, params, stats):
    """``nn.Conv2d`` + ``BatchNorm`` holding a JAX ``FusedConv1x1BN``'s
    variables (kernel HWIO → OIHW)."""
    k, n = kernel.shape[2:]
    conv = torch.nn.Conv2d(k, n, 1, stride=stride, bias=False)
    bn = BatchNorm(n)
    with torch.no_grad():
        conv.weight.copy_(_t(np.transpose(kernel, (3, 2, 0, 1))))
        bn.weight.copy_(_t(params["scale"]))
        bn.bias.copy_(_t(params["bias"]))
        bn.running_mean.copy_(_t(stats["mean"]))
        bn.running_var.copy_(_t(stats["var"]))
    return conv, bn


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("impl", ["pallas", "gram"])
def test_conv1x1_bn_matches_jax_module(impl, stride):
    r = np.random.default_rng(2 + stride)
    x = r.uniform(-2, 2, (4, 8, 8, 12)).astype(np.float32)
    mod = FusedConv1x1BN(features=24, stride=stride, impl=impl)
    v = jax.tree.map(np.asarray, mod.init(jax.random.PRNGKey(0), x, train=True))
    v["params"]["scale"] = r.uniform(0.5, 1.5, 24).astype(np.float32)
    v["params"]["bias"] = r.normal(0, 0.2, 24).astype(np.float32)
    jy, jmut = mod.apply(v, x, train=True, mutable=["batch_stats"])
    jeval = mod.apply({"params": v["params"], "batch_stats": jmut["batch_stats"]}, x,
                      train=False)
    t = r.uniform(-1, 1, np.asarray(jy).shape).astype(np.float32)

    def loss(params, xi):
        y, _ = mod.apply({"params": params, "batch_stats": v["batch_stats"]}, xi,
                         train=True, mutable=["batch_stats"])
        return jnp.mean(jnp.sin(y) * t)

    jgp, jgx = jax.grad(loss, (0, 1))(v["params"], x)

    conv, bn = _port_pair(v["params"]["kernel"], stride, v["params"], v["batch_stats"])
    tx = _t(x).requires_grad_()
    y = tconv_bn.conv1x1_bn(tx.permute(0, 3, 1, 2), conv, bn, impl).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **MODULE_TOL)
    np.testing.assert_allclose(bn.running_mean.numpy(), jmut["batch_stats"]["mean"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), jmut["batch_stats"]["var"],
                               rtol=1e-4, atol=1e-5)
    (torch.sin(y) * _t(t)).mean().backward()
    np.testing.assert_allclose(conv.weight.grad.numpy(),
                               np.transpose(np.asarray(jgp["kernel"]), (3, 2, 0, 1)),
                               **GRAD_TOL)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(jgp["scale"]), **GRAD_TOL)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(jgp["bias"]), **GRAD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    bn.eval()
    with torch.no_grad():
        ye = tconv_bn.conv1x1_bn(_t(x).permute(0, 3, 1, 2), conv, bn, impl)
    np.testing.assert_allclose(ye.permute(0, 2, 3, 1).numpy(), np.asarray(jeval), **MODULE_TOL)


@pytest.mark.parametrize("batch, jax_route", [(2, "conv1x1_stats"), (1, "gram_stats")])
def test_conv1x1_bn_takes_gram_when_rows_are_not_a_multiple_of_8(monkeypatch, batch, jax_route):
    """The JAX module takes its gram route when N·H·W % 8 != 0 (Mosaic's
    row tiles need 8-row multiples: 2·2·2 = 8 rows take the kernel here,
    1·2·2 = 4 rows the gram form). The port's ``impl='pallas'`` runs
    ``conv1x1_stats`` at every row count, and matches JAX's either way."""
    calls = {"jax": [], "port": []}

    def record(owner, module, name):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, _fn=fn: calls[owner].append(name) or _fn(*a))

    r = np.random.default_rng(batch)
    x = r.uniform(-2, 2, (batch, 2, 2, 12)).astype(np.float32)
    mod = FusedConv1x1BN(features=16, impl="pallas")
    v = jax.tree.map(np.asarray, mod.init(jax.random.PRNGKey(1), x, train=True))
    for name in ("conv1x1_stats", "gram_stats"):
        record("jax", pallas_conv_bn, name)
        record("port", tconv_bn, name)
    jy, _ = mod.apply(v, x, train=True, mutable=["batch_stats"])
    conv, bn = _port_pair(v["params"]["kernel"], 1, v["params"], v["batch_stats"])
    with torch.no_grad():
        y = tconv_bn.conv1x1_bn(_t(x).permute(0, 3, 1, 2), conv, bn, "pallas")
    assert calls == {"jax": [jax_route], "port": ["conv1x1_stats"]}
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(jy), **MODULE_TOL)


def _load_block(block, params, stats):
    """Unfused JAX Bottleneck slots → the port block's reference names."""
    names = {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "conv3", "Conv_3": "downsample.0",
             "BatchNorm_0": "bn1", "BatchNorm_1": "bn2", "BatchNorm_2": "bn3",
             "BatchNorm_3": "downsample.1"}
    mods = dict(block.named_modules())
    with torch.no_grad():
        for slot, name in names.items():
            if slot.startswith("Conv"):
                mods[name].weight.copy_(_t(np.transpose(params[slot]["kernel"], (3, 2, 0, 1))))
            else:
                mods[name].weight.copy_(_t(params[slot]["scale"]))
                mods[name].bias.copy_(_t(params[slot]["bias"]))
                mods[name].running_mean.copy_(_t(stats[slot]["mean"]))
                mods[name].running_var.copy_(_t(stats[slot]["var"]))


@pytest.mark.parametrize("impl", ["pallas", "gram"])
def test_downsampling_bottleneck_with_stat_fusion_matches_jax(impl):
    """A stride-2 Bottleneck with a downsample projection, its 1x1 convs
    fused: output, running statistics of all four norm layers and every
    weight gradient."""
    r = np.random.default_rng(4)
    x = r.uniform(-1, 1, (2, 8, 8, 16)).astype(np.float32)
    blk = JaxBottleneck(planes=8, stride=2, downsample=True,
                        norm=jax_make_norm("bn", axis_name=None), stat_fusion=impl)
    v = jax.tree.map(np.asarray, blk.init(jax.random.PRNGKey(0), x, train=True))
    jy, jmut = blk.apply(v, x, train=True, mutable=["batch_stats"])
    t = r.uniform(-1, 1, np.asarray(jy).shape).astype(np.float32)

    def loss(params):
        y, _ = blk.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                         train=True, mutable=["batch_stats"])
        return jnp.mean((y - t) ** 2)

    jg = jax.grad(loss)(v["params"])

    def unfuse(params, stats):   # the block map applies to a block in a tree
        up, us = tconv_bn.unfuse_variables({"b": params}, {"b": stats})
        return up["b"], us["b"]

    up, us = unfuse(v["params"], v["batch_stats"])
    port = Bottleneck(16, 8, 2, True, BatchNorm, stat_fusion=impl)
    _load_block(port, up, us)
    y = port.train()(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **MODULE_TOL)
    mut = unfuse(v["params"], jmut["batch_stats"])[1]
    gu = unfuse(jg, v["batch_stats"])[0]
    ((y - _t(t)) ** 2).mean().backward()
    mods = dict(port.named_modules())
    for slot, name in [("0", "1"), ("1", "2"), ("2", "3"), ("3", None)]:
        conv = mods[f"conv{name}" if name else "downsample.0"]
        bn = mods[f"bn{name}" if name else "downsample.1"]
        np.testing.assert_allclose(bn.running_mean.numpy(), mut[f"BatchNorm_{slot}"]["mean"],
                                   rtol=1e-4, atol=1e-5, err_msg=slot)
        np.testing.assert_allclose(bn.running_var.numpy(), mut[f"BatchNorm_{slot}"]["var"],
                                   rtol=1e-4, atol=1e-5, err_msg=slot)
        np.testing.assert_allclose(
            conv.weight.grad.numpy(),
            np.transpose(np.asarray(gu[f"Conv_{slot}"]["kernel"]), (3, 2, 0, 1)),
            rtol=1e-3, atol=1e-6, err_msg=slot)
        np.testing.assert_allclose(bn.weight.grad.numpy(),
                                   np.asarray(gu[f"BatchNorm_{slot}"]["scale"]),
                                   rtol=1e-3, atol=1e-6, err_msg=slot)


def test_stat_fusion_rejects_other_norm_kinds():
    with pytest.raises(ValueError, match="stat_fusion"):
        build_encoder("ResNet50", norm_kind="frozen", stat_fusion="gram")
    with pytest.raises(ValueError, match="stat_fusion"):
        build_encoder("ResNet50", stat_fusion="cuda")
    # BasicBlock architectures ignore it
    enc = build_encoder("ResNet10", stat_fusion="pallas")
    assert sorted(enc.state_dict()) == sorted(build_encoder("ResNet10").state_dict())


# ---------------------------------------------------------------------------
# JAX variables of the fused layout


def _fused_shape_variables(arch, norm_kind):
    model = JaxSimCLR(arch=arch, axis_name=None, norm_kind=norm_kind, stat_fusion="pallas")
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.PRNGKey(0), jnp.ones((2, 30, 30, 12)))
    rng = np.random.default_rng(3)
    fill = lambda s: rng.normal(0, 1, s.shape).astype(np.float32)  # noqa: E731
    return jax.tree.map(fill, dict(shapes))


def _renamed(tree, old, new):
    if not isinstance(tree, dict):
        return tree
    return {k.replace(old, new): _renamed(v, old, new) for k, v in tree.items()}


@pytest.mark.parametrize("norm_kind", ["bn", "bn_fused"])
def test_from_jax_variables_reads_the_fused_layout(norm_kind):
    """Fused-layout ResNet-50 variables map as their unfused conversion
    does. With ``bn_fused`` the JAX model names its 3x3 norms
    ``FusedStatsBatchNorm_k``, which the JAX converter does not know: the
    reference side renames them to ``BatchNorm_k`` first."""
    fused = _fused_shape_variables("ResNet50", norm_kind)
    assert tconv_bn.is_fused_layout(fused["params"])
    unfused = convert_stat_fusion_variables(
        _renamed(fused, "FusedStatsBatchNorm_", "BatchNorm_"), to_fused=False)
    assert not tconv_bn.is_fused_layout(unfused["params"])
    got = from_jax_variables(fused["params"], fused["batch_stats"])
    want = from_jax_variables(unfused["params"], unfused["batch_stats"])
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    # one layout for the port, fused or not
    port = SimCLRModule(arch="ResNet50", stat_fusion="pallas")
    port.load_state_dict(got)
    assert sorted(port.state_dict()) == sorted(got)
    # a fused slot that no block map covers is refused, never mis-mapped
    params = dict(fused["params"])
    params["FusedConv1x1BN_9"] = {"kernel": np.zeros((1, 1, 2, 2), np.float32)}
    with pytest.raises(ValueError, match="FusedConv1x1BN"):
        from_jax_variables(params, fused["batch_stats"])
