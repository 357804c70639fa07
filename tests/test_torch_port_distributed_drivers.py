"""The port's downstream steps and all five drivers on 2 CPU ranks.

The probe, DETR, caption and RLS steps run as real 2-process gloo jobs
(``torch_port_distributed_cases``) on their rows of an 8-row global batch,
with the port's own seeded weights and draws, and are held against the
port's 1-rank step on the whole batch; the DETR step also against the JAX
package's GSPMD step on ``mesh2`` (``tests/test_mesh_steps.py``'s DETR
test). Then each driver as a real 2-process CLI run on the CPU (the sizes
of ``tools/multiprocess_drivers.sh``): rank 0 alone prints and writes, the
readers' shards are disjoint and cover the catalog, ``--multislice`` is
accepted and ``--stat-fusion pallas`` gets the JAX driver's refusal.
"""

import json
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from multimodal_active_ai_tpu.models import detr as jdetr
from multimodal_active_ai_tpu.ops import retina as jr
from multimodal_active_ai_tpu.train import detr_train as jdetr_train
from multimodal_active_ai_tpu.train.simclr_train import TrainState as JaxState
from multimodal_active_ai_tpu_torch.data.readers import compute_shard_size
from multimodal_active_ai_tpu_torch.utils import checkpoint as tckpt
from test_torch_port_detr import _numpy_params, _random_frozen_stats
from torch_port_distributed_cases import (CLASSES, DETR_SMALL, GEOM, F, run_driver, run_local,
                                          run_ranks)

GB = 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _normwise(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def _two_vs_one(case, tmp_path, inputs=None):
    ranks = run_ranks(case, tmp_path, inputs)
    r0, r1 = ranks
    assert all(torch.equal(r0[k], r1[k]) for k in r0 if k not in ("reward", "saccades"))
    return r0, ranks, run_local(case, inputs)


def _grads_agree(two, one, tol, only=lambda k: True):
    """Each gradient to ``tol`` of its largest element; a gradient that is
    zero in exact arithmetic (the DETR decoder's first self-attention on
    zero targets leaves ~1e-13 of rounding) to ``tol`` of a millionth of
    the largest gradient."""
    keys = [k for k in one if k.startswith("grad.") and only(k)]
    assert keys
    floor = 1e-6 * max(float(one[k].abs().max()) for k in keys)
    for k in keys:
        d = float((two[k] - one[k]).abs().max())
        assert d <= tol * max(float(one[k].abs().max()), floor), (k, _normwise(two[k], one[k]))


def _adam_weights_agree(two, one, keys, lr, steps):
    """Adam-family updates move a weight by about ``lr`` whatever the size
    of its gradient: a weight whose gradient is within rounding of zero (an
    attention key bias, whose gradient is zero in exact arithmetic) may
    step the other way. Every weight agrees to ``2·lr·steps``, the median
    difference is below ``lr/1000``."""
    diffs = []
    for k in keys:
        d = (two[k] - one[k]).abs()
        assert float(d.max()) <= 2 * lr * steps * (1 + 1e-3), (k, float(d.max()))
        diffs.append(d.flatten())
    assert float(torch.cat(diffs).median()) <= 1e-3 * lr


# ---------------------------------------------------------------------------
# the steps, 2 ranks against 1


def test_probe_step_on_two_ranks_equals_one_rank(tmp_path):
    """Two SGD updates of the probe and the eval step: the losses and the
    eval metrics are the global batch's on both ranks (1e-6 relative),
    the averaged gradient is the 8-row batch's (normwise 1e-5: float32
    sums in another order) and so are the weights (1e-5)."""
    two, _, one = _two_vs_one("probe", tmp_path)
    np.testing.assert_allclose(two["losses"].numpy(), one["losses"].numpy(), rtol=1e-6)
    for k in ("loss", "top1", "top5"):
        np.testing.assert_allclose(float(two[f"eval.{k}"]), float(one[f"eval.{k}"]), rtol=1e-6)
    _grads_agree(two, one, 1e-5)
    for k in ("linear.weight", "linear.bias"):
        assert _normwise(two[k], one[k]) <= 1e-5, k


def test_detr_step_on_two_ranks_equals_one_rank(tmp_path):
    """Two DETR updates (AdamW groups, StepLR, the global-norm clip active:
    the norm is the averaged gradient's, 1e-5 relative) on the steps' own
    draws, then the eval step: losses and metrics to 1e-5, the clipped
    averaged gradient to normwise 1e-4, the frozen stem exactly, the
    trained weights as Adam allows."""
    two, _, one = _two_vs_one("detr", tmp_path)
    for k in ("loss_ce", "class_error", "grad_norm"):
        np.testing.assert_allclose(two[k].numpy(), one[k].numpy(), rtol=1e-5, err_msg=k)
    assert float(one["grad_norm"][0]) > 0.1
    for k in ("loss_ce", "top1", "top5"):
        np.testing.assert_allclose(float(two[f"eval.{k}"]), float(one[f"eval.{k}"]), rtol=1e-5)
    _grads_agree(two, one, 1e-4)
    frozen = [k for k in one if k.startswith("backbone.0.body.") and
              not k.startswith(("backbone.0.body.layer2", "backbone.0.body.layer3",
                                "backbone.0.body.layer4"))]
    assert frozen and all(torch.equal(two[k], one[k]) for k in frozen)
    trained = [k for k in one if not k.startswith(("grad.", "eval.", "loss_ce", "class_error",
                                                   "grad_norm")) and k not in frozen
               and one[k].is_floating_point()]
    _adam_weights_agree(two, one, trained, 1e-3, 2)


def test_caption_step_on_two_ranks_equals_one_rank(tmp_path):
    """Two caption-probe updates (Adam; the symmetric InfoNCE over all 8
    pairs with both towers' gradient, through the differentiable gather)
    and the eval step (retrieval over all 8 pairs): losses and metrics to
    1e-5, the averaged gradient to normwise 1e-4, the weights as Adam
    allows."""
    two, _, one = _two_vs_one("caption", tmp_path)
    np.testing.assert_allclose(two["losses"].numpy(), one["losses"].numpy(), rtol=1e-5)
    for k in ("loss", "i2t_top1", "i2t_top5", "t2i_top1", "t2i_top5"):
        np.testing.assert_allclose(float(two[f"eval.{k}"]), float(one[f"eval.{k}"]), rtol=1e-5)
    _grads_agree(two, one, 1e-4)
    weights = [k for k in one if k.startswith(("image_head.", "text."))]
    _adam_weights_agree(two, one, weights, 1e-3, 2)


def test_rls_steps_on_two_ranks_equal_one_rank(tmp_path):
    """The RLS train step with the policy choosing saccades: the global
    loss and reward (1e-5), each rank's saccades and per-sample reward its
    rows of the 1-rank rollout's (exactly), the DETR weights as Adam
    allows; both eval steps' metrics (1e-5). Then the DQN update on a
    global replay batch of 8, each rank its 4 rows: the loss (1e-5), the
    heads' clamped averaged gradient (normwise 1e-4); the trunk's runs
    through the train-mode BatchNorm on 0..255 glimpses, whose float32
    gradient is ill-conditioned: in one process, the same 8 rows in another
    order move it by up to 3.1% (layer1.0.conv2), and the 2-rank gradient
    sits that far too, so it is held to normwise 5e-2 (a per-rank
    statistic would move the heads' gradient and the running statistics
    far beyond their bounds); the running statistics, taken over all 8
    rows, to 1e-5."""
    two, ranks, one = _two_vs_one("rls", tmp_path)
    for k in ("train.loss_ce", "train.reward_mean", "train.grad_norm", "dqn.loss"):
        np.testing.assert_allclose(float(two[k]), float(one[k]), rtol=1e-5, err_msg=k)
    for r, out in enumerate(ranks):
        rows = slice(r * 4, (r + 1) * 4)
        assert torch.equal(out["saccades"], one["saccades"][rows])
        assert torch.equal(out["reward"], one["reward"][rows])
    for greedy in (False, True):
        for k in ("loss_ce", "top1", "top5"):
            np.testing.assert_allclose(float(two[f"eval.{greedy}.{k}"]),
                                       float(one[f"eval.{greedy}.{k}"]), rtol=1e-5)
    _grads_agree(two, one, 1e-4, only=lambda k: not k.startswith("grad.f."))
    _grads_agree(two, one, 5e-2, only=lambda k: k.startswith("grad.f."))
    for k in one:
        if k.startswith("dqn.") and k.endswith(("running_mean", "running_var")):
            assert _normwise(two[k], one[k]) <= 1e-5, k
    detr = [k for k in one if k.startswith("detr.") and one[k].is_floating_point()]
    _adam_weights_agree(two, one, detr, 1e-3, 1)


def test_detr_step_on_two_ranks_matches_jax_on_mesh2(tmp_path, mesh2):
    """``tests/test_mesh_steps.py``'s DETR equivalence, across the packages:
    the JAX step of the 8-row batch on ``mesh2`` (GSPMD) and the port's on 2
    ranks × 4 rows, one plain SGD update (lr 0.05) from the same weights on
    JAX's draws. The loss to 1e-4 relative (float32 and the rare bf16
    rounding step of a glimpse element), the weights to that test's
    tolerances (rtol 5e-3, atol 5e-5)."""
    model, crit = jdetr.build(SimpleNamespace(dataset="synthetic", backbone="ResNet10",
                                              pre_norm=False, position_embedding="sine",
                                              backbone_norm="frozen", **DETR_SMALL),
                              num_classes=CLASSES)
    v = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.ones((2, F, 30, 30, 12)),
                       jnp.full((2, F, 2), 0.5))
    rng = np.random.default_rng(0)
    params = _numpy_params(v["params"], rng)
    stats = _random_frozen_stats(v["batch_stats"], rng)
    images = np.random.default_rng(1).integers(0, 256, (GB, 64, 64, 3), dtype=np.uint8)
    labels = np.arange(GB) % CLASSES
    state = JaxState.create(apply_fn=model.apply, params=params, tx=optax.sgd(0.05),
                            batch_stats=stats)
    key = jax.random.PRNGKey(9)
    step = jdetr_train.make_detr_train_step(model, crit, mesh2, jr.RetinaConfig(**GEOM), F)
    new, m = step(state, jnp.asarray(images), jnp.asarray(labels), key)
    k_n, k_s = jax.random.split(jax.random.split(key)[0])
    num_fixs = int(jax.random.randint(k_n, (), 1, F + 1))
    sacc = jnp.stack([jax.random.uniform(k, (GB, 2)) for k in jax.random.split(k_s, F)], 1)
    ranks = run_ranks("detr", tmp_path, {
        "jax_sd": tckpt.from_jax_detr_variables(params, stats), "jax_images": _t(images),
        "jax_labels": _t(labels), "jax_num_fixs": torch.tensor(num_fixs),
        "jax_saccades": _t(sacc), "jax_f": torch.tensor(F)})
    want = tckpt.from_jax_detr_variables(jax.device_get(new.params), stats)
    for out in ranks:
        np.testing.assert_allclose(float(out["jax.loss_ce"]), float(m["loss_ce"]), rtol=1e-4)
        for k, w in want.items():
            np.testing.assert_allclose(out[f"jax.sd.{k}"].numpy(), w.numpy(), rtol=5e-3,
                                       atol=5e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the five drivers as 2-process CLI runs

COMMON = ["--device", "cpu", "--dataset", "synthetic", "--canvas-size", "64", "-b", "4",
          "-t", "--epochs", "1", "--num-examples", "16", "-p", "1"]
DETR_DIMS = ["--enc_layers", "1", "--dec_layers", "1", "--hidden_dim", "32", "--nheads", "2",
             "--dim_feedforward", "64", "--backbone", "ResNet18", "--num-classes", "10"]


def _rank_dirs(tmp_path, name):
    dirs = [tmp_path / name / f"rank{r}" for r in range(2)]
    for d in dirs:
        d.mkdir(parents=True)
    return dirs


def _ran(results, rank0_lines=()):
    """Both ranks exited 0; rank 0 printed ``rank0_lines``, rank 1 printed
    none of them (rank 0 alone prints)."""
    for r, (code, log) in enumerate(results):
        assert code == 0, f"rank {r}:\n{log[-3000:]}"
    for line in rank0_lines:
        assert line in results[0][1], (line, results[0][1][-3000:])
        assert line not in results[1][1], (line, results[1][1][-3000:])


def _written_by_rank0_alone(dirs, *names):
    """Rank 0's directory holds ``names``, rank 1's nothing."""
    for name in names:
        assert (dirs[0] / name).is_file(), name
    assert not any(dirs[1].iterdir()), list(dirs[1].iterdir())


@pytest.fixture(scope="module")
def simclr_run(tmp_path_factory):
    """The SimCLR driver as a 2-rank job (ResNet18, F = 2, ``--multislice``,
    ``-v``): its logs and rank 0's checkpoint."""
    dirs = _rank_dirs(tmp_path_factory.mktemp("drivers"), "simclr")
    results = run_driver("contrastive_learning", COMMON + ["--arch", "ResNet18", "-f", "2",
                                                           "--multislice", "-v"], dirs)
    yield dirs, results
    shutil.rmtree(dirs[0].parent.parent)      # every driver's checkpoints: large


def test_simclr_driver_as_a_two_rank_job(simclr_run):
    """Every rank trains its shard of the global batch of 8 (``Speed``
    counts it) and validates over all 8 rows; rank 0 alone prints and
    writes ``checkpoint.pth.tar``; ``--multislice`` is accepted and prints
    the nodes × local-ranks layout; ``-v`` prints the collectives of a
    step: NT-Xent's 4 all-gathers, the 20 BatchNorms' sums in 3 forwards
    and 2 backwards and the metrics' one, 2 gradient all-reduces."""
    dirs, results = simclr_run
    _ran(results, ["distributed: 2 ranks, backend gloo (the CPU)",
                   "multislice: 1 node(s) x 2 local rank(s)",
                   "global batch 8 (4/rank)", "Epoch: [0][3/4]", "##Contrastive Top-1",
                   "collectives a step (4 steps): gather 4.0 calls 0.01 MB | sum 101.0 calls "])
    assert "rank 1 of 2 on cpu" in results[1][1]
    _written_by_rank0_alone(dirs, "checkpoint.pth.tar")
    payload = tckpt.load_checkpoint(str(dirs[0] / "checkpoint.pth.tar"))
    assert payload["step"] == 4 * 2 and np.isfinite(payload["loss_history"]).all()
    assert all(torch.isfinite(v).all() for v in payload["state_dict"].values()
               if v.is_floating_point())


def test_probe_driver_as_a_two_rank_job(simclr_run):
    dirs = _rank_dirs(simclr_run[0][0].parent.parent, "probe")
    ckpt = str(simclr_run[0][0] / "checkpoint.pth.tar")
    _ran(run_driver("representation_evaluation",
                    [ckpt] + COMMON + ["--arch", "ResNet18", "-f", "2", "--num-classes", "10"],
                    dirs), ["=> loaded pretrained model", "##Top-1", "Epoch: [0][3/4]"])
    _written_by_rank0_alone(dirs, "classifier_checkpoint.pth.tar")


def test_detr_driver_as_a_two_rank_job(simclr_run):
    dirs = _rank_dirs(simclr_run[0][0].parent.parent, "detr")
    ckpt = str(simclr_run[0][0] / "checkpoint.pth.tar")
    _ran(run_driver("detr_image_classification", [ckpt] + COMMON + DETR_DIMS + ["-f", "2"],
                    dirs), ["=> loaded pretrained backbone", "##Top-1", "Epoch: [0][3/4]"])
    _written_by_rank0_alone(dirs, "detr_classifier_checkpoint.pth.tar")


def test_rls_driver_as_a_two_rank_job(simclr_run):
    """``-dqnb 8`` is the global replay batch: each rank samples 4 rows of
    its own ring, and the DQN's BatchNorm is ``sync_bn``."""
    dirs = _rank_dirs(simclr_run[0][0].parent.parent, "rls")
    ckpt = str(simclr_run[0][0] / "checkpoint.pth.tar")
    _ran(run_driver("detr_image_classification_rls",
                    [ckpt] + COMMON + DETR_DIMS + ["-f", "3", "--dqn", "ResNet18", "-dqnb", "8",
                                                   "--replay-memory-capacity", "16",
                                                   "--target-update-freq", "1",
                                                   "--num-of-actions", "10"], dirs),
         ["##Policy Top-1", "DQN-Loss"])
    _written_by_rank0_alone(dirs, "detr_classifier_checkpoint.pth.tar", "dqn_checkpoint.pth.tar")
    dqn = tckpt.load_checkpoint(str(dirs[0] / "dqn_checkpoint.pth.tar"))
    assert dqn["step"] >= 1       # seed 15's coins update the DQN in a 4-step run


def test_caption_driver_as_a_two_rank_job(simclr_run):
    dirs = _rank_dirs(simclr_run[0][0].parent.parent, "caption")
    ckpt = str(simclr_run[0][0] / "checkpoint.pth.tar")
    _ran(run_driver("coco_captions_probe",
                    [ckpt, "--device", "cpu", "--dataset", "synthetic", "--canvas-size", "64",
                     "-b", "4", "-t", "--epochs", "1", "--num-examples", "16", "-p", "1",
                     "-a", "ResNet18", "-f", "2"], dirs), ["##I2T Top-1", "Epoch: [0][0/4]"])
    _written_by_rank0_alone(dirs, "caption_probe_checkpoint.pth.tar")


def test_driver_shards_are_disjoint_and_cover_the_catalog(tmp_path):
    """The SimCLR driver on a folder of 20 train and 8 val images, each a
    solid colour of its own, as a 2-rank job with one shared
    ``--canvas-cache``: each rank's cache holds its shard's canvases, so
    their colours name the files each rank read. The train shards hold
    ``compute_shard_size`` = 10 images each, are disjoint and cover the
    catalog."""
    colours = {}
    for split, n in (("train", 20), ("val", 8)):
        d = tmp_path / "data" / split / "c0"
        d.mkdir(parents=True)
        for i in range(n):
            c = (8 * i + (0 if split == "train" else 4), 255 - 9 * i, 100)
            Image.new("RGB", (48, 40), c).save(d / f"{i:02d}.png")
            if split == "train":
                colours[c] = i
    dirs = _rank_dirs(tmp_path, "simclr_files")
    cache = tmp_path / "cache"
    _ran(run_driver("contrastive_learning",
                    ["--device", "cpu", "--dataset", "imagenet", str(tmp_path / "data"),
                     "--canvas-size", "64", "-b", "4", "-t", "--epochs", "1", "-p", "1",
                     "--arch", "ResNet10", "-f", "1", "-j", "1", "--canvas-cache", str(cache)],
                    dirs), ["Epoch: [0][2/3]"])
    shards = []
    for meta in sorted(cache.glob("*.json")):
        n = json.loads(meta.read_text())["n"]
        if n != compute_shard_size(20, 0, 2, 4):
            continue                               # a val shard
        rows = np.fromfile(meta.with_suffix(".u8"), np.uint8).reshape(n, 64, 64, 3)
        shards.append({colours[tuple(int(v) for v in row[32, 32])] for row in rows})
    assert len(shards) == 2 and compute_shard_size(20, 1, 2, 4) == 10
    assert not shards[0] & shards[1] and shards[0] | shards[1] == set(range(20))
    shutil.rmtree(dirs[0].parent)       # rank 0's checkpoints: large


def test_stat_fusion_pallas_is_refused_on_two_ranks(tmp_path):
    """``--stat-fusion pallas`` (the B3 kernel) is single-device in both
    packages: at world 2 every rank exits with the JAX driver's words;
    ``gram`` is the multi-device route."""
    dirs = _rank_dirs(tmp_path, "pallas")
    for code, log in run_driver("contrastive_learning",
                                COMMON + ["--arch", "ResNet50", "--stat-fusion", "pallas"], dirs):
        assert code != 0
        assert ("--stat-fusion pallas is single-device only; use --stat-fusion gram on "
                "multi-device meshes") in log
