"""The port's data parallelism against the JAX package's, on 2 CPU ranks.

Each port case runs as a real 2-process gloo job (``torch_port_distributed_
cases.run_ranks``: the port's ``initialize_distributed``, a ``file://``
rendezvous, a timeout and no stray process) on its rows of a global batch
made from a numpy seed. Its JAX reference is the same function of the
global batch: on one device, and for the SimCLR step also GSPMD on the
``mesh2`` fixture (2 devices), with the port's weights carried from the JAX
variables by ``from_jax_variables``. The collectives, ``SyncBatchNorm``,
NT-Xent with rank offsets, then the whole SimCLR step (ResNet10, canvas 64,
F = 2, 2 ranks × b = 4, float32), which is also held against the port's own
1-rank step on the 8-row batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax.sharding import PartitionSpec as P

from multimodal_active_ai_tpu.models import SimCLRModule as JaxSimCLR
from multimodal_active_ai_tpu.objectives.ntxent import contrastive_loss as jax_ntxent
from multimodal_active_ai_tpu.ops import retina as jr
from multimodal_active_ai_tpu.parallel.collectives import cross_replica_concat as jax_concat
from multimodal_active_ai_tpu.parallel.mesh import create_mesh
from multimodal_active_ai_tpu.train import optimizers as joptim
from multimodal_active_ai_tpu.train import schedule as jsched
from multimodal_active_ai_tpu.train import simclr_train as jtrain
from multimodal_active_ai_tpu_torch.utils import checkpoint as tckpt
from torch_port_distributed_cases import GEOM, run_local, run_ranks

WORLD, B = 2, 4                      # ranks, rows a rank
GB = WORLD * B                       # the global batch
F, T = 2, 0.05
# lr 0.01 linearly scaled to the global batch of 8, no warmup
LR_ARGS = (0.01, GB, 16, GB, 0, 5)
LR = jsched.simclr_learning_rate(*LR_ARGS)(0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _normwise(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return np.abs(got - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max()


# ---------------------------------------------------------------------------
# collectives


def test_cross_replica_concat_matches_jax(tmp_path, mesh2):
    """Forward: every rank's rows in rank order. Gradient of
    ``Σ gathered · W[rank]``: the local block's only with the local block
    differentiable (torch's ``dist.all_gather``), none with it detached, and
    with the fully differentiable gather the sum over ranks of every rank's
    cotangent of this rank's block, each counted once. JAX: the same losses
    under ``shard_map`` on ``mesh2``; float32, exact sums of two terms."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(GB, 3)).astype(np.float32)
    w = rng.normal(size=(WORLD, GB, 3)).astype(np.float32)
    ranks = run_ranks("concat", tmp_path, {"x": _t(x), "w": _t(w)})

    def jax_grad(local):
        def per_device(xs, ws):
            def loss(xs):
                g = (jax_concat(xs, "data") if local else
                     jax.lax.all_gather(xs, "data", tiled=True))
                return jnp.sum(g * ws[0])
            return jax.grad(loss)(xs)
        return np.asarray(jax.jit(jax.shard_map(
            per_device, mesh=mesh2, in_specs=(P("data"), P("data")), out_specs=P("data"),
            check_vma=False))(jnp.asarray(x), jnp.asarray(w)))

    local, full = jax_grad(True), jax_grad(False)
    for r, out in enumerate(ranks):
        rows = slice(r * B, (r + 1) * B)
        for name in ("local", "detached", "full"):
            np.testing.assert_array_equal(out[f"{name}.y"].numpy(), x)
        assert "detached.grad" not in out
        np.testing.assert_array_equal(out["local.grad"].numpy(), w[r, rows])
        np.testing.assert_allclose(out["local.grad"].numpy(), local[rows], rtol=0, atol=0)
        np.testing.assert_allclose(out["full.grad"].numpy(), w[:, rows].sum(0), rtol=1e-6)
        np.testing.assert_allclose(out["full.grad"].numpy(), full[rows], rtol=1e-6)


def test_sync_batchnorm_matches_flax_over_the_global_batch(tmp_path):
    """``SyncBatchNorm`` over 2 × 4 rows against flax ``BatchNorm`` over all
    8 (momentum 0.9, ε 1e-5, train mode) on un-centred inputs under the
    loss ``Σ y · G``: output, running statistics (biased variance), input
    gradient and the affine gradients summed over ranks. float32 sums in
    another order: 1e-5 normwise."""
    rng = np.random.default_rng(1)
    x = rng.normal(2.0, 3.0, (GB, 5, 3, 3)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bias = rng.normal(0, 0.1, 5).astype(np.float32)
    ranks = run_ranks("syncbn", tmp_path, {"x": _t(x), "g": _t(g), "weight": _t(scale),
                                           "bias": _t(bias)})

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(5), "var": jnp.ones(5)}}

    def loss(params, xs):
        y, mutated = bn.apply({**variables, "params": params}, xs, mutable=["batch_stats"])
        return jnp.sum(y * nhwc(g)), (y, mutated["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], nhwc(x))
    y, gx = np.asarray(y).transpose(0, 3, 1, 2), np.asarray(gx).transpose(0, 3, 1, 2)
    for r, out in enumerate(ranks):
        rows = slice(r * B, (r + 1) * B)
        assert _normwise(out["y"], y[rows]) <= 1e-5
        assert _normwise(out["x.grad"], gx[rows]) <= 1e-5
        assert _normwise(out["weight.grad"], gp["scale"]) <= 1e-5
        assert _normwise(out["bias.grad"], gp["bias"]) <= 1e-5
        assert _normwise(out["running_mean"], stats["mean"]) <= 1e-5
        assert _normwise(out["running_var"], stats["var"]) <= 1e-5
    assert all(torch.equal(ranks[0][k], ranks[1][k])
               for k in ("weight.grad", "bias.grad", "running_mean", "running_var"))


@pytest.fixture(scope="module")
def syncbn_fused(tmp_path_factory):
    """``case_syncbn_fused`` over 2 × 4 rows of 5 channels (un-centred;
    ``x_clamp``'s last two channels two values near 96, multiples of 2^-7
    whose float32 squares are multiples of 2^-4, so that every partial sum
    of ``x`` and ``x²`` is exact in any order and the one-pass variance
    falls below 0 by the rounding of the two divisions by 72 alone), and
    flax ``BatchNorm`` (momentum
    0.9, ε 1e-5, train mode) over all 8 rows with the residual add and the
    ReLU, under the loss ``Σ y · G``, for each variant of ``x``."""
    rng = np.random.default_rng(4)
    x = rng.normal(2.0, 3.0, (GB, 5, 3, 3)).astype(np.float32)
    x_clamp = x.copy()
    for ch, (low, high, k) in zip((3, 4), ((95.984375, 96.0, 48), (95.984375, 95.9921875, 24))):
        values = np.array([low] * k + [high] * (GB * 9 - k), dtype=np.float32)
        x_clamp[:, ch] = rng.permutation(values).reshape(GB, 3, 3)
    g = rng.normal(size=x.shape).astype(np.float32)
    identity = rng.normal(size=x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bias = rng.normal(0, 0.1, 5).astype(np.float32)
    mean0 = rng.uniform(-1, 1, 5).astype(np.float32)
    var0 = rng.uniform(0.5, 2, 5).astype(np.float32)
    ranks = run_ranks("syncbn_fused", tmp_path_factory.mktemp("syncbn_fused"),
                      {"x": _t(x), "x_clamp": _t(x_clamp), "g": _t(g), "identity": _t(identity),
                       "weight": _t(scale), "bias": _t(bias), "running_mean": _t(mean0),
                       "running_var": _t(var0)})

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    flax = {}
    for name, with_id, relu in (("id.relu", True, True), ("id", True, False),
                                ("relu", False, True), ("plain", False, False)):
        def loss(params, xs, ids):
            y, mutated = bn.apply({**variables, "params": params}, xs, mutable=["batch_stats"])
            y = y + ids if with_id else y
            y = jax.nn.relu(y) if relu else y
            return jnp.sum(y * nhwc(g)), (y, mutated["batch_stats"])

        (_, (y, stats)), (gp, gx, gid) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            variables["params"], nhwc(x), nhwc(identity))
        flax[name] = {"y": nchw(y), "x.grad": nchw(gx), "identity.grad": nchw(gid),
                      "weight.grad": np.asarray(gp["scale"]), "bias.grad": np.asarray(gp["bias"]),
                      "running_mean": np.asarray(stats["mean"]),
                      "running_var": np.asarray(stats["var"])}
    return ranks, flax


@pytest.mark.parametrize("variant", ["id.relu", "id", "relu", "plain", "clamp", "uneven"])
def test_fused_sync_batchnorm_matches_the_chain_and_flax(syncbn_fused, variant):
    """The fused ``sync_bn`` Function's arithmetic (its kernels' plain
    versions) on 2 ranks against ``SyncBatchNorm``'s chain on the same
    ranks: output, ``dx``, the residual's gradient, this rank's weight and
    bias gradients and the running buffers (one more batch tracked), to
    1e-5 normwise (float32 sums in another order); and, summed over ranks
    where a gradient is the batch's, against flax ``BatchNorm`` over the
    global batch to the same 1e-5. ``clamp``: both sides clamp the same
    channels' variance (some, not all), and ``dx`` is held to 1e-3, the
    bound of ``tests/test_torch_port_bn_act.py``'s clamped case for the
    same reason (``rsqrt(ε)`` magnifies the rounding of ``x − mean``), which
    a gradient term left in the clamped channels would exceed by its whole
    size; flax takes its own order there, so it is not compared. ``uneven``:
    rank 0 brings one row fewer, and the Function takes the row count from
    the summed buffer as the chain does (no flax batch to compare)."""
    ranks, flax = syncbn_fused
    keys = ["y", "x.grad", "weight.grad", "bias.grad", "running_mean", "running_var"]
    keys += ["identity.grad"] if variant.startswith("id") else []
    for r, out in enumerate(ranks):
        assert int(out[f"{variant}.fused.num_batches_tracked"]) == 1
        assert f"{variant}.fused.identity.grad" in out or not variant.startswith("id")
        for k in keys:
            tol = 1e-3 if (variant, k) == ("clamp", "x.grad") else 1e-5
            assert _normwise(out[f"{variant}.fused.{k}"], out[f"{variant}.chain.{k}"]) <= tol, k
        if variant == "clamp":
            flag = out["clamp.fused.flag"]
            assert torch.equal(flag, out["clamp.chain.flag"])
            assert not flag[:3].any() and flag[3:].any()
            continue
        if variant == "uneven":
            assert out["uneven.fused.y"].shape[0] == (B - 1 if r == 0 else B)
            continue
        rows = slice(r * B, (r + 1) * B)
        want = flax[variant]
        for k in keys:
            got = out[f"{variant}.fused.{k}"]
            if k in ("weight.grad", "bias.grad"):
                got = ranks[0][f"{variant}.fused.{k}"] + ranks[1][f"{variant}.fused.{k}"]
            ref = want[k][rows] if k in ("y", "x.grad", "identity.grad") else want[k]
            assert _normwise(got, ref) <= 1e-5, k
    for k in ("running_mean", "running_var"):
        assert torch.equal(ranks[0][f"{variant}.fused.{k}"], ranks[1][f"{variant}.fused.{k}"])


def test_fused_sync_batchnorm_sums_on_every_rank_whatever_it_needs(syncbn_fused):
    """One forward and backward of the fused ``sync_bn`` Function when only
    rank 0's input needs a gradient (the weight and bias on both): both
    ranks make the same two ``collectives.sum`` calls, one each way, so
    neither waits on the other, and each holds the chain's weight
    gradient of its rows (the ``relu`` variant's)."""
    ranks, _ = syncbn_fused
    assert [int(out["sum_calls"]) for out in ranks] == [2, 2]
    for out in ranks:
        assert _normwise(out["no_input_grad.weight.grad"], out["relu.chain.weight.grad"]) <= 1e-5


@pytest.mark.parametrize("torch_gather_semantics", [True, False])
def test_ntxent_with_rank_offsets_matches_jax_on_the_global_batch(tmp_path,
                                                                  torch_gather_semantics):
    """Each rank's loss is the mean over its rows, so the mean over ranks is
    the JAX loss of the global batch; its ``logits_ab`` are its rows of the
    global ``(8, 8)`` logits and its labels point at ``rank·b + i``; its
    gradients, divided by the world size, are its rows of the JAX gradient:
    with torch's gather semantics through the local (left) operands only,
    without them through the differentiable gather too. float32: 1e-5
    relative, 1e-5 normwise for the gradients."""
    rng = np.random.default_rng(2)
    h1, h2 = (rng.normal(size=(GB, 16)).astype(np.float32) for _ in range(2))
    ranks = run_ranks("ntxent", tmp_path, {"h1": _t(h1), "h2": _t(h2), "t": torch.tensor(0.5)})
    tgs = torch_gather_semantics

    def loss(a, b):
        return jax_ntxent(a, b, temperature=0.5, torch_gather_semantics=tgs)

    (jloss, (jlogits, _)), grads = jax.value_and_grad(
        lambda a, b: (lambda o: (o[0], o[1:]))(loss(a, b)), argnums=(0, 1), has_aux=True)(
            jnp.asarray(h1), jnp.asarray(h2))
    mean_loss = np.mean([float(out[f"{tgs}.loss"]) for out in ranks])
    np.testing.assert_allclose(mean_loss, float(jloss), rtol=1e-5)
    for r, out in enumerate(ranks):
        rows = slice(r * B, (r + 1) * B)
        assert out[f"{tgs}.logits_ab"].shape == (B, GB)
        np.testing.assert_allclose(out[f"{tgs}.logits_ab"].numpy(), np.asarray(jlogits)[rows],
                                   rtol=1e-5, atol=1e-6)
        assert out[f"{tgs}.labels"].shape == (B, 2 * GB)
        np.testing.assert_array_equal(out[f"{tgs}.labels"].argmax(1).numpy(),
                                      np.arange(B) + r * B)
        for name, jg in zip(("h1", "h2"), grads):
            assert _normwise(out[f"{tgs}.{name}.grad"] / WORLD, np.asarray(jg)[rows]) <= 1e-5


# ---------------------------------------------------------------------------
# the SimCLR step


def _views(key, n_views, src, batch):
    """The per-view AugParams and noise that ``jax.random`` gives a step's
    view keys ``(kp, kn)`` for ``batch`` rows, as the port's tensors."""
    cfg = jr.RetinaConfig(**GEOM)
    g, ch = cfg.glimpse_size, cfg.num_channels
    params, noise = [], []
    for kp, kn in key[:n_views]:
        p = jr.sample_unlabeled_params(kp, batch, src, cfg)
        params.append([_t(x) for x in p])
        nz = jax.vmap(lambda k: jax.random.normal(k, (g, g, ch)))(jax.random.split(kn, batch))
        noise.append(_t(nz))
    return params, noise


@pytest.fixture(scope="module")
def simclr(mesh2, tmp_path_factory):
    """The JAX SimCLR step of the 8-row global batch on ``mesh2`` and on one
    device, and the port's on 2 ranks × 4 rows and on 1 rank × 8 rows, from
    equal weights, images and draws."""
    model = JaxSimCLR(arch="ResNet10", axis_name=None, norm_kind="bn")
    tx = joptim.get_optimizer("adam", jsched.simclr_learning_rate(*LR_ARGS))
    state0 = jtrain.create_train_state(model, tx, jax.random.PRNGKey(0),
                                       jnp.ones((2, 30, 30, 12)))
    images = np.random.default_rng(1).integers(0, 256, (GB, 64, 64, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(2)
    jcfg = jr.RetinaConfig(**GEOM)
    jax_runs = {}
    for name, mesh in (("mesh2", mesh2),
                       ("one", create_mesh(data=1, model=1, devices=jax.devices()[:1]))):
        step = jtrain.make_train_step(model, mesh, jcfg, F, T, donate=False)
        state1, metrics = step(state0, jnp.asarray(images), key)
        jax_runs[name] = (np.asarray(metrics["losses"]), tckpt.from_jax_variables(
            jax.device_get(state1.params), jax.device_get(state1.batch_stats)))
    params, noise = _views(jax.random.split(key, 2 * (F + 1)).reshape(F + 1, 2, 2), F + 1,
                           64, GB)
    inputs = {"sd": tckpt.from_jax_variables(jax.device_get(state0.params),
                                             jax.device_get(state0.batch_stats)),
              "images": _t(images), "params": params, "noise": noise,
              "lr_args": torch.tensor(LR_ARGS, dtype=torch.float64),
              "t": torch.tensor(T), "num_fixations": torch.tensor(F)}
    ranks = run_ranks("simclr", tmp_path_factory.mktemp("simclr"), inputs)
    return dict(jax=jax_runs, ranks=ranks, one=run_local("simclr", inputs))


def _weights_agree(got: dict, want: dict, prefix: str = "", running: float = 5e-3,
                   stepped: float = 0.05) -> None:
    """The structure of ``tests/test_torch_port_train.py``'s tolerances after
    F Adam updates: Adam's first steps move each weight by about ``lr``
    whatever the size of its gradient, so a weight whose gradient is within
    rounding of zero may step differently; every weight agrees to
    ``2·lr·F``, the median to 1% of ``lr``, at most a share ``stepped`` of
    the weights by more than ``lr/10``; the running statistics to
    ``running`` of each tensor's largest value. The defaults are that
    test's."""
    diffs = []
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[prefix + k]) == 1 + F, k
            continue
        d = np.abs(got[prefix + k].numpy() - w.numpy())
        if k.endswith(("running_mean", "running_var")):
            assert d.max() <= running * np.abs(w.numpy()).max(), k
            continue
        assert d.max() <= 2 * LR * F * (1 + 1e-3), (k, d.max())
        diffs.append(d.ravel())
    diffs = np.concatenate(diffs)
    assert np.median(diffs) <= 1e-2 * LR
    assert (diffs > 0.1 * LR).mean() <= stepped


@pytest.mark.parametrize("jax_mesh", ["mesh2", "one"])
def test_simclr_step_on_two_ranks_matches_jax(simclr, jax_mesh):
    """The port's step on 2 ranks × 4 rows, fed the JAX-sampled AugParams
    and noise of the global batch (each rank its rows), against the JAX
    step of the 8-row batch on ``mesh2`` and on one device: the
    per-fixation losses (the global batch's, on every rank) to 2e-3
    relative, as in ``tests/test_torch_port_train.py``, and the weights
    after the F updates in that test's structure, for its reasons. At this
    batch the port's own 1-rank step sits as far from JAX as its 2-rank
    step (measured: running statistics 1.29% of the largest value, in
    layer4.0.bn2's mean after the second fixation; 4.7% of the weights more
    than lr/10 apart; JAX's two meshes differ by 0.08% and 1.3%), so the
    bounds are 2% and 8%; the 2-rank step against the 1-rank one is held
    to that test's own bounds below."""
    losses, want = simclr["jax"][jax_mesh]
    for out in simclr["ranks"]:
        np.testing.assert_allclose(out["given.losses"].numpy(), losses, rtol=2e-3)
        _weights_agree(out, want, "given.sd.", running=2e-2, stepped=0.08)


def test_simclr_step_leaves_both_ranks_bit_identical(simclr):
    """The averaged gradient, the global BatchNorm statistics and the
    optimizer agree on every rank: after the step both ranks hold the same
    weights, running statistics and metrics, bit for bit."""
    r0, r1 = simclr["ranks"]
    keys = [k for k in r0 if k != "view0"]
    assert len(keys) > 100 and all(torch.equal(r0[k], r1[k]) for k in keys)


def test_simclr_step_on_two_ranks_equals_one_rank(simclr):
    """The port on 2 ranks × 4 rows against the port on 1 rank × 8 rows.
    With the step's own draws each rank draws the global batch's view and
    keeps its rows: bit for bit the 1-rank view's. Then float32 alone
    separates the two runs (BatchNorm sums and the gradient average in
    another order, through BatchNorm's ill-conditioned gradient on 0..255
    glimpses): the losses to 1e-4 relative (measured 5e-5, on the second
    fixation, after one update), the eval loss to 1e-3 (measured 4e-4),
    top-1/top-5 exactly, and the weights at the tolerances of the JAX
    comparison (measured: median 6e-4·lr, 1.6% above lr/10)."""
    one = simclr["one"]
    for r, out in enumerate(simclr["ranks"]):
        assert torch.equal(out["view0"], one["view0"][r * B:(r + 1) * B])
        for drawn in ("given", "generator"):
            np.testing.assert_allclose(out[f"{drawn}.losses"].numpy(),
                                       one[f"{drawn}.losses"].numpy(), rtol=1e-4)
            np.testing.assert_allclose(float(out[f"{drawn}.eval.loss"]),
                                       float(one[f"{drawn}.eval.loss"]), rtol=1e-3)
            for k in ("top1", "top5"):
                assert float(out[f"{drawn}.eval.{k}"]) == float(one[f"{drawn}.eval.{k}"])
            want = {k[len(f"{drawn}.sd."):]: v for k, v in one.items()
                    if k.startswith(f"{drawn}.sd.")}
            _weights_agree(out, want, f"{drawn}.sd.")
