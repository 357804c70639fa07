"""The fused BatchNorm + residual + ReLU of ``ops/bn_act.py``, held on the CPU.

The CUDA kernels and the autograd Function around them run only on the
card (``chip_smoke.py`` phase 2 holds the kernels against the plain
versions, phase 3l a ResNet-50 update through the Function against the
unfused chain). Here the plain versions, which repeat the kernels'
arithmetic in plain torch, are held against autograd of today's chain:
``models/norm.BatchNorm`` in train mode, then the add and the ReLU. On the
CPU ``conv_norm_act`` takes that chain, no kernel is launched, and the
Function refuses CPU tensors.
"""

import pytest
import torch

from multimodal_active_ai_tpu_torch.models import norm as norm_mod
from multimodal_active_ai_tpu_torch.models.norm import BatchNorm, SyncBatchNorm, conv_norm_act
from multimodal_active_ai_tpu_torch.models.resnet import build_encoder
from multimodal_active_ai_tpu_torch.ops import bn_act as ba

WRAPPERS = (ba.bn_act_sums, ba.bn_act_apply, ba.bn_act_grad_sums, ba.bn_act_grad_apply)
# (identity, relu) as the ResNet calls them: a norm + ReLU, a shortcut's
# norm, a block's end; and a residual without ReLU
VARIANTS = [(False, True), (False, False), (True, True), (True, False)]


def _inputs(dtype, shape=(6, 8, 5, 7), seed=0):
    gen = torch.Generator().manual_seed(seed)
    c = shape[1]
    offsets = torch.linspace(-1, 3, c).view((1, c) + (1,) * (len(shape) - 2))
    x = torch.randn(shape, generator=gen) * 2 + offsets
    identity = torch.randn(shape, generator=gen)
    weight = torch.rand(c, generator=gen) + 0.5
    bias = torch.randn(c, generator=gen)
    g = torch.randn(shape, generator=gen)
    return x.to(dtype), identity.to(dtype), weight, bias, g.to(dtype)


def _module(c, weight, bias):
    bn = BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
        gen = torch.Generator().manual_seed(c)
        bn.running_mean.uniform_(-1, 1, generator=gen)
        bn.running_var.uniform_(0.5, 2, generator=gen)
    return bn


def _chain(bn, x, identity, relu):
    out = bn(x)
    if identity is not None:
        out = out + identity
    return torch.relu(out) if relu else out


def _plain_forward(bn, x, identity, relu):
    """The fused forward's plain versions on ``bn``'s parameters and
    buffers: the sums, then the statistics, the running update and the
    apply pass. Returns the output and the ``(3, C)`` statistics."""
    return ba.bn_act_apply_plain(x, ba.bn_act_sums_plain(x), bn.weight.detach(),
                                 bn.bias.detach(), bn.running_mean, bn.running_var,
                                 bn.num_batches_tracked, bn.momentum, bn.eps, identity, relu)


def _stats(x, eps=1e-5):
    return ba.stats_from_sums_plain(ba.bn_act_sums_plain(x), eps)[0]


def _both(dtype, with_identity, relu, x=None):
    """Forward and backward of the chain (autograd) and of the fused
    kernels' plain versions (``bn_act_grad_plain`` for the backward) from
    the same inputs and buffers; returns both sides' output, gradients and
    buffers."""
    x0, id0, weight, bias, g = _inputs(dtype)
    x0 = x0 if x is None else x
    id0 = id0 if with_identity else None
    bn = _module(x0.shape[1], weight, bias)
    x = x0.clone().requires_grad_()
    identity = None if id0 is None else id0.clone().requires_grad_()
    y = _chain(bn, x, identity, relu)
    y.backward(g)
    chain = {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
             "did": None if identity is None else identity.grad,
             "buffers": {k: v.clone() for k, v in bn.named_buffers()}}
    bn = _module(x0.shape[1], weight, bias)
    y, stats = _plain_forward(bn, x0, id0, relu)
    dx, dw, db, gy = ba.bn_act_grad_plain(g, x0, y if relu else None, stats, bn.weight.detach())
    fused = {"y": y, "dx": dx, "dw": dw, "db": db, "did": None if id0 is None else gy,
             "buffers": {k: v.clone() for k, v in bn.named_buffers()}}
    return chain, fused


def _rel(got, ref):
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max())


@pytest.mark.parametrize("with_identity, relu", VARIANTS)
def test_float32_matches_the_chain(with_identity, relu):
    """float32: the forward, its statistics and the running update bit for
    bit (the same ops in the same order); the gradients to summation order
    (the chain's backward takes other sums than the fused formula)."""
    chain, fused = _both(torch.float32, with_identity, relu)
    assert torch.equal(fused["y"], chain["y"])
    for k, v in chain["buffers"].items():
        assert torch.equal(fused["buffers"][k], v), k
    assert fused["buffers"]["num_batches_tracked"] == 1
    for k in ("dx", "dw", "db"):
        assert _rel(fused[k], chain[k]) < 1e-5, k
    if with_identity:
        assert torch.equal(fused["did"], chain["did"])
    else:
        assert fused["did"] is None


@pytest.mark.parametrize("with_identity, relu", VARIANTS)
def test_bfloat16_matches_the_chain(with_identity, relu):
    """bf16 storage, float32 statistics and arithmetic. Without a residual
    both round once and agree bit for bit; with one the chain rounds the
    normalised value to bf16 before the add and the fused version does
    not, so outputs differ by at most one bf16 step of the largest value
    (2^-7 of it), and the ReLU mask flips where the sum lies within that
    step of 0 (at most 1% of the elements). Where the masks agree ``dx``
    (rounded to bf16 from float32 arithmetic on both sides) is within 2e-2
    of the largest and ``d identity`` is the same bits; ``dw`` and ``db``
    within 2e-2 plus what the flipped elements' gradients add to them."""
    chain, fused = _both(torch.bfloat16, with_identity, relu)
    assert fused["y"].dtype == torch.bfloat16 and fused["dx"].dtype == torch.bfloat16
    if with_identity:
        assert _rel(fused["y"], chain["y"]) <= 2 ** -7
    else:
        assert torch.equal(fused["y"], chain["y"])
    for k, v in chain["buffers"].items():
        assert torch.equal(fused["buffers"][k], v), k
    flip = ((chain["y"] > 0) != (fused["y"] > 0) if relu
            else torch.zeros_like(chain["y"], dtype=torch.bool))
    assert flip.float().mean() <= 1e-2
    keep = ~flip
    dx = (fused["dx"].float() - chain["dx"].float()).abs()[keep]
    assert float(dx.max()) < 2e-2 * float(chain["dx"].float().abs().max())
    x, _, _, _, g = _inputs(torch.bfloat16)
    stats = _stats(x)
    xhat = (x.float() - stats[0].view(1, -1, 1, 1)) * stats[1].view(1, -1, 1, 1)
    gf = g.float() * flip
    for k, slack in (("db", gf.abs().sum((0, 2, 3))), ("dw", (gf * xhat).abs().sum((0, 2, 3)))):
        err = (fused[k] - chain[k]).abs()
        assert bool((err <= 2e-2 * chain[k].abs().max() + slack).all()), k
    if with_identity:
        assert torch.equal(fused["did"][keep], chain["did"][keep])


def test_a_clamped_variance_cuts_its_gradient_term():
    """Channels whose one-pass variance ``E[x²] − E[x]²`` falls below 0 in
    float32 (values near 100 that differ by ~1e-3): the variance is
    clamped at 0, and autograd of the chain's ``clamp_min`` passes no
    gradient to it. The fused backward gives 0 to that term there too. The
    tolerance on ``dx`` is 1e-3: with ``rsqrt(ε)`` ≈ 316 the two sides'
    roundings of ``x − mean`` near 100 reach ~4e-5 of the largest
    gradient, and a term left in would move it by its whole size."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(6, 8, 5, 7, generator=gen)
    x[:, 4:] = 100 + 1e-3 * torch.randn(6, 4, 5, 7, generator=gen)
    stats = _stats(x)
    clamped = stats[2] != 0
    assert clamped[4:].any() and not clamped[:4].any()
    assert torch.equal(stats[1][clamped], torch.full((int(clamped.sum()),), 1e-5) ** -0.5)
    for relu in (True, False):
        chain, fused = _both(torch.float32, False, relu, x=x)
        assert torch.equal(fused["y"], chain["y"])
        assert _rel(fused["dx"], chain["dx"]) < 1e-3
        assert _rel(fused["dw"], chain["dw"]) < 1e-5


@pytest.mark.parametrize("shape", [(5, 3), (4, 6, 9), (2, 16, 3, 3)], ids=str)
def test_other_ranks(shape):
    """The plain versions' channel dim is dim 1 at any rank (a 1-D ResNet's
    ``(B, C, L)``, a ``(rows, C)`` matrix): the output and the running
    buffers bit for bit."""
    x, identity, weight, bias, g = _inputs(torch.float32, shape)
    ref_bn = _module(shape[1], weight, bias)
    ref = _chain(ref_bn, x, identity, True)
    bn = _module(shape[1], weight, bias)
    y, _ = _plain_forward(bn, x, identity, True)
    assert torch.equal(y, ref)
    for (k, v), ref_v in zip(bn.named_buffers(), ref_bn.buffers()):
        assert torch.equal(v, ref_v), k


def test_plain_grad_alone_matches_autograd_of_the_plain_forward():
    """``bn_act_grad_plain`` against autograd through ``bn_act_sums_plain``,
    ``stats_from_sums_plain`` and ``normalize_act_plain``: the fused formula
    is that gradient."""
    x, identity, weight, bias, g = _inputs(torch.float32)
    xr = x.clone().requires_grad_()
    w = weight.clone().requires_grad_()
    b = bias.clone().requires_grad_()
    y = ba.normalize_act_plain(xr, _stats(xr), w, b, identity, True)
    y.backward(g)
    stats = _stats(x)
    dx, dw, db, gy = ba.bn_act_grad_plain(g, x, y.detach(), stats, weight)
    assert _rel(dx, xr.grad) < 1e-5 and _rel(dw, w.grad) < 1e-5 and _rel(db, b.grad) < 1e-5
    assert torch.equal(gy, torch.where(y.detach() <= 0, 0.0, g))


def test_identity_of_another_shape_or_type_is_refused():
    x, identity, weight, bias, _ = _inputs(torch.float32)
    bn = _module(x.shape[1], weight, bias)
    args = (bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.num_batches_tracked, 0.9,
            1e-5)
    with pytest.raises(ValueError, match="identity"):
        ba.batch_norm_act(x, *args, identity.to(torch.bfloat16))
    with pytest.raises(ValueError, match="identity"):
        ba.batch_norm_act(x, *args, identity[:1])


def test_cpu_tensors_are_refused():
    """The Function runs the kernels alone: a CPU tensor is refused, and
    ``conv_norm_act`` never sends it one (``fusable``)."""
    x, _, weight, bias, _ = _inputs(torch.float32)
    bn = _module(x.shape[1], weight, bias)
    with pytest.raises(ValueError, match="CUDA only"):
        ba.batch_norm_act(x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                          bn.num_batches_tracked, 0.9, 1e-5)
    assert int(bn.num_batches_tracked) == 0


@pytest.mark.parametrize("channels_last", [True, False])
def test_rows_view_round_trip(channels_last):
    """``_rows`` is the channels-last ``(rows, C)`` view (free for
    ``channels_last`` memory, a copy otherwise) and ``_unrows`` its inverse."""
    x = torch.randn(2, 5, 3, 4)
    if channels_last:
        x = x.to(memory_format=torch.channels_last)
    rows = ba._rows(x)
    assert rows.shape == (24, 5) and rows.is_contiguous()
    assert (rows.data_ptr() == x.data_ptr()) == channels_last
    assert torch.equal(rows, x.permute(0, 2, 3, 1).reshape(24, 5))
    back = ba._unrows(rows, (2, 3, 4, 5))
    assert torch.equal(back, x) and back.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("arch", ["ResNet10", "ResNet50"])
def test_conv_norm_act_takes_the_chain_on_the_cpu(arch):
    """On the CPU a ResNet's train-mode forward and backward run the norm,
    the add and the ReLU one after the other, as before: no kernel is
    launched, and every BatchNorm's running statistics move."""
    for w in WRAPPERS:
        w.launches = 0
    model = build_encoder(arch, generator=torch.Generator().manual_seed(0))
    model(torch.randn(2, 30, 30, 12)).square().mean().backward()
    assert [w.launches for w in WRAPPERS] == [0, 0, 0, 0]
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert len(bns) == {"ResNet10": 12, "ResNet50": 53}[arch]
    assert all(int(m.num_batches_tracked) == 1 for m in bns)


def test_conv_norm_act_chain_is_the_modules_forward():
    """The chain ``conv_norm_act`` runs is the conv, the module, then
    ``+ identity``, then ``torch.relu``: bit for bit, in train and eval
    mode."""
    x, identity, weight, bias, _ = _inputs(torch.float32)
    conv = torch.nn.Conv2d(8, 8, 1, bias=False)
    for train in (True, False):
        a, b = _module(8, weight, bias).train(train), _module(8, weight, bias).train(train)
        assert torch.equal(conv_norm_act(conv, a, x, identity), torch.relu(b(conv(x)) + identity))
        assert torch.equal(conv_norm_act(conv, a, x, identity, relu=False),
                           b(conv(x)) + identity)
        assert torch.equal(conv_norm_act(conv, a, x, relu=False), b(conv(x)))


def test_fusable_only_for_train_mode_batchnorm_on_the_card(monkeypatch):
    """The fused Function is taken for a train-mode ``BatchNorm`` or
    ``SyncBatchNorm`` (at any world size: at world > 1 over every rank's
    rows) on a CUDA tensor of bf16 or float32, with a residual of its type,
    alone: seen here by standing in a CUDA flag on CPU tensors."""
    x = torch.randn(2, 4, 3, 3)
    assert not norm_mod.fusable(BatchNorm(4), x)           # the CPU
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    for m in (BatchNorm(4), SyncBatchNorm(4)):
        assert norm_mod.fusable(m, x) and norm_mod.fusable(m, x.bfloat16(), x.bfloat16())
    for m in (BatchNorm(4).eval(), norm_mod.FusedStatsBatchNorm(4),
              norm_mod.FrozenBatchNorm(4), norm_mod.GroupNormAdapter(4)):
        assert not norm_mod.fusable(m, x)
    assert not norm_mod.fusable(BatchNorm(4), x.double())
    assert not norm_mod.fusable(BatchNorm(4), x, x.bfloat16())
    monkeypatch.setattr(norm_mod, "world_size", lambda: 2)
    assert norm_mod.fusable(SyncBatchNorm(4), x) and norm_mod.fusable(BatchNorm(4), x)


@pytest.mark.parametrize("world", [1, 2])
def test_conv_norm_act_routes_sync_bn_by_world_size(monkeypatch, world):
    """Where ``fusable``, ``conv_norm_act`` hands a ``SyncBatchNorm`` to the
    Function with ``sync`` (the statistics of every rank's rows) at world >
    1 and without it at world 1, a ``BatchNorm`` without it at any world,
    and counts each train-mode ``SyncBatchNorm`` call by route: ``fused``
    here, ``chain`` through the module on the CPU; eval mode is not
    counted. Seen by standing in a CUDA flag and the Function on CPU
    tensors."""
    calls = []
    monkeypatch.setattr(norm_mod, "world_size", lambda: world)
    monkeypatch.setattr(norm_mod.bn_act, "batch_norm_act", lambda x, *a: calls.append(a[9]) or x)
    conv = torch.nn.Identity()
    x = torch.randn(2, 4, 3, 3)
    norm_mod.reset_sync_bn_counts()
    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        conv_norm_act(conv, SyncBatchNorm(4), x)
        conv_norm_act(conv, BatchNorm(4), x)
    assert calls == [world > 1, False]
    assert norm_mod.sync_bn_counts() == {"fused": 1, "chain": 0}
    monkeypatch.setattr(norm_mod, "world_size", lambda: 1)   # no process group on the CPU
    conv_norm_act(conv, SyncBatchNorm(4), x)
    conv_norm_act(conv, SyncBatchNorm(4).eval(), x)
    assert norm_mod.sync_bn_counts() == {"fused": 1, "chain": 1}
    assert norm_mod.sync_bn_line(2) == "sync_bn calls a step (2 steps): fused 0.5 | chain 0.5"
    norm_mod.reset_sync_bn_counts()
    assert norm_mod.sync_bn_counts() == {"fused": 0, "chain": 0}


@pytest.mark.parametrize("split", [1, 17, 29])
def test_sums_of_parts_add_to_the_whole(split):
    """The ``(2C + 1,)`` sums buffer ends in its rows, so the buffers of
    two parts of a batch (two ranks' rows, unequal when ``split`` is not
    half), added as the all-reduce adds them, give the whole batch's
    statistics, running update and output: the count the apply pass and
    the gradient pass divide by is the parts' total."""
    x, _, weight, bias, g = _inputs(torch.float32, (6, 8, 2, 3))
    rows = ba._rows(x)
    parts = ba.bn_act_sums_plain(rows[:split]) + ba.bn_act_sums_plain(rows[split:])
    assert float(parts[-1]) == rows.shape[0]
    whole = _module(8, weight, bias)
    y, stats = ba.bn_act_apply_plain(rows, ba.bn_act_sums_plain(rows), weight, bias,
                                     whole.running_mean, whole.running_var,
                                     whole.num_batches_tracked, 0.9, 1e-5)
    bn = _module(8, weight, bias)
    y_p, stats_p = ba.bn_act_apply_plain(rows, parts, weight, bias, bn.running_mean,
                                         bn.running_var, bn.num_batches_tracked, 0.9, 1e-5)
    assert _rel(stats_p, stats) < 1e-6 and _rel(y_p, y) < 1e-5
    for k, v in whole.named_buffers():
        assert _rel(getattr(bn, k), v) < 1e-6, k
    g2d = ba._rows(g)
    dw, db = ba.bn_act_grad_sums_plain(g2d, rows, y, stats)
    dx, _ = ba.bn_act_grad_apply_plain(g2d, rows, y, stats, weight, dw, db)
    dx_p, _ = ba.bn_act_grad_apply_plain(g2d, rows, y, stats, weight, dw, db, parts[-1:])
    assert torch.equal(dx_p, dx)
