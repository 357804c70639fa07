"""The port's dropout against the JAX package's semantics.

* Attention dropout is flax's ``broadcast_dropout=True``: one ``(1, 1, Sq,
  Sk)`` keep mask a call, the same in every batch row and head, kept
  weights scaled by ``1/(1 - p)``; eval mode matches the JAX ``_MHA``.
* Every dropout mask is drawn from an explicit generator that the trainers
  hand each train step and the drivers make from ``--seed`` and the epoch:
  two DETR, RLS and caption driver runs at one seed, dropout 0.1, are bit
  for bit the same, another seed is not. No test here seeds torch's global
  generator.
* Element-wise masks are drawn for the global batch and sliced per rank,
  so a 2-rank gloo job with dropout 0.1 equals the 1-rank step of the
  global batch (``torch_port_distributed_cases``), at the tolerances of the
  dropout-0 cases in ``test_torch_port_distributed_drivers.py``.
"""

import math
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_active_ai_tpu.models.transformer import _MHA
from multimodal_active_ai_tpu_torch import coco_captions_probe as caption_driver
from multimodal_active_ai_tpu_torch import detr_image_classification as detr_driver
from multimodal_active_ai_tpu_torch import detr_image_classification_rls as rls_driver
from multimodal_active_ai_tpu_torch.models.detr import DETR
from multimodal_active_ai_tpu_torch.models.text import GlimpseCaptioner, TextEncoder
from multimodal_active_ai_tpu_torch.models.transformer import MultiheadAttention, dropout
from multimodal_active_ai_tpu_torch.utils import checkpoint as tckpt
from test_torch_port_distributed_drivers import _adam_weights_agree, _grads_agree, _two_vs_one
from torch_port_distributed_cases import CLASSES, DETR_SMALL

torch.set_num_threads(1)


def _within_4_sigma(kept: int, n: int, keep: float) -> bool:
    return abs(kept / n - keep) <= 4 * math.sqrt(keep * (1 - keep) / n)


def _mha(d=16, h=4, p=0.5) -> MultiheadAttention:
    return MultiheadAttention(d, h, p, generator=torch.Generator().manual_seed(0))


def test_attention_dropout_is_one_mask_for_the_batch_and_every_head():
    """Train mode at p = 0.5: the zero pattern of the weights is the same in
    every batch row and head, the keep rate is within 4σ of 0.5, and the
    kept weights are the eval-mode softmax scaled by 2."""
    mha = _mha()
    g = torch.Generator().manual_seed(1)
    q, k = torch.randn(6, 24, 16, generator=g), torch.randn(6, 20, 16, generator=g)
    soft = mha.eval().attention_weights(q, k)
    w = mha.train().attention_weights(q, k, generator=torch.Generator().manual_seed(2))
    zero = w == 0
    assert torch.equal(zero, zero[:1, :1].expand_as(zero))
    assert _within_4_sigma(int((~zero[0, 0]).sum()), 24 * 20, 0.5)
    torch.testing.assert_close(w[~zero], 2 * soft[~zero], rtol=1e-6, atol=0)


def test_activation_dropout_is_element_wise():
    """``dropout`` on activations: an element-wise mask (rows differ), the
    keep rate within 4σ, kept values scaled by ``1/(1 - p)``."""
    x = torch.rand(8, 16, 32) + 1.0
    y = dropout(x, 0.1, torch.Generator().manual_seed(3))
    kept = y != 0
    assert not torch.equal(kept[0], kept[1])
    assert _within_4_sigma(int(kept.sum()), x.numel(), 0.9)
    torch.testing.assert_close(y[kept], x[kept] / 0.9)
    assert dropout(x, 0.0, None) is x


@pytest.mark.parametrize("model", ["detr", "text", "captioner"])
def test_every_attention_of_the_models_draws_one_broadcast_mask(model, monkeypatch):
    """Through the DETR, the text tower and the glimpse captioner in train
    mode at p = 0.5: every attention call's zero pattern is one ``(Sq, Sk)``
    pattern for all rows and heads (no padding, so every softmax weight is
    positive), and the keep rate over all calls is within 4σ of 0.5."""
    seen = []
    weights_of = MultiheadAttention.attention_weights

    def record(self, *args, **kwargs):
        w = weights_of(self, *args, **kwargs)
        seen.append(w == 0)
        return w

    monkeypatch.setattr(MultiheadAttention, "attention_weights", record)
    g = torch.Generator().manual_seed(4)
    init = torch.Generator().manual_seed(5)
    if model == "detr":
        # GroupNorm: features of unit scale, so no softmax weight underflows
        net = DETR("ResNet10", CLASSES, **{**DETR_SMALL, "dropout": 0.5}, backbone_norm="group",
                   generator=init)
        args = (torch.rand(2, 3, 30, 30, 12, generator=g) * 255, torch.rand(2, 3, 2, generator=g))
    elif model == "text":
        net = TextEncoder(vocab_size=64, d_model=32, nhead=2, num_layers=2, dim_feedforward=64,
                          out_dim=16, dropout=0.5, generator=init)
        args = (torch.randint(1, 64, (3, 12), generator=g),)
    else:
        net = GlimpseCaptioner(40, vocab_size=64, d_model=32, nhead=2, num_layers=2,
                               dim_feedforward=64, dropout=0.5, generator=init)
        args = (torch.randn(3, 5, 40, generator=g), torch.randint(1, 64, (3, 7), generator=g))
    net.train()(*args, generator=torch.Generator().manual_seed(6))
    assert seen
    kept = n = 0
    for zero in seen:
        assert torch.equal(zero, zero[:1, :1].expand_as(zero))
        if model == "captioner" and zero.shape[-1] == zero.shape[-2] == 7:
            valid = torch.ones(7, 7, dtype=torch.bool).tril()   # causal self-attention
        else:
            valid = torch.ones(zero.shape[-2:], dtype=torch.bool)
        kept += int((~zero[0, 0] & valid).sum())
        n += int(valid.sum())
    assert _within_4_sigma(kept, n, 0.5)


def test_train_mode_dropout_needs_a_generator():
    """As flax raises without a ``dropout`` key: train mode with a rate
    above 0 and no generator raises; eval mode and rate 0 need none."""
    mha = _mha().train()
    q = torch.randn(2, 4, 16)
    with pytest.raises(ValueError, match="explicit generator"):
        mha(q, q, q)
    mha.eval()(q, q, q)
    _mha(p=0.0).train()(q, q, q)


def test_eval_mode_matches_the_jax_mha():
    """Eval mode (dropout 0.1 set, deterministic) against the JAX
    ``_MHA`` with the same numpy weights, with and without a key padding
    mask: 1e-5."""
    rng = np.random.default_rng(7)
    d, h = 16, 4
    q = rng.standard_normal((3, 5, d)).astype(np.float32)
    kv = rng.standard_normal((3, 6, d)).astype(np.float32)
    pad = np.zeros((3, 6), bool)
    pad[1, 4:] = True
    jmod = _MHA(d, h, 0.1)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), q, kv, kv)
    params = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32),
                          shapes["params"])
    port = _mha(d, h, 0.1)
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                          tckpt._mha_from_flax(params["MultiHeadDotProductAttention_0"]).items()})
    port.eval()
    for mask in (None, pad):
        want = jmod.apply({"params": params}, q, kv, kv, None if mask is None else
                          jnp.asarray(mask), deterministic=True)
        got = port(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
                   None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the drivers: dropout as a function of --seed

COMMON = ["--dataset", "synthetic", "-b", "4", "--canvas-size", "64", "-t", "--device", "cpu",
          "-p", "1", "--epochs", "1"]
DETR_SMALL_ARGS = ["--backbone", "ResNet10", "--num-classes", str(CLASSES), "--enc_layers", "1",
                   "--dec_layers", "1", "--hidden_dim", "32", "--nheads", "2",
                   "--dim_feedforward", "64", "--num_queries", "5", "--backbone-norm", "group",
                   "--dropout", "0.1"]
DRIVERS = {
    "detr": (detr_driver.main, DETR_SMALL_ARGS + ["-f", "3", "--num-examples", "8"]),
    "rls": (rls_driver.main, DETR_SMALL_ARGS + ["--dqn", "ResNet10", "-f", "3", "-dqnb", "4",
                                                "--replay-memory-capacity", "8",
                                                "--num-of-actions", "10", "--num-examples", "12"]),
    "caption": (caption_driver.main, ["-a", "ResNet10", "-f", "2", "--num-examples", "8",
                                      "--vocab-size", "97", "--max-len", "8"]),
}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_dropout_is_a_function_of_the_seed(name, tmp_path, capsys):
    """Two CPU runs of the driver at ``--seed 15`` (dropout 0.1: DETR's and
    RLS's transformer, the caption text tower's default) print the same
    losses and end with bit-identical weights; ``--seed 16`` differs."""
    main, args = DRIVERS[name]

    def run(seed):
        out = main(COMMON + args + ["--seed", seed, "--checkpoint-dir", str(tmp_path)])
        shutil.rmtree(tmp_path)             # the checkpoints are not read here
        state = out if name == "detr" else out[0]
        losses = re.findall(r"Loss (\S+)", capsys.readouterr().out)
        return losses, {k: v.clone() for k, v in state.model.state_dict().items()}

    (l1, w1), (l2, w2), (l3, w3) = run("15"), run("15"), run("16")
    assert l1 and l1 == l2 and sorted(w1) == sorted(w2)
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert l3 != l1 and not all(torch.equal(w1[k], w3[k]) for k in w1)


# ---------------------------------------------------------------------------
# 2 ranks against 1, dropout 0.1

DROP = {"dropout": 0.1}


def test_detr_step_with_dropout_on_two_ranks_equals_one_rank(tmp_path):
    """``test_detr_step_on_two_ranks_equals_one_rank`` at dropout 0.1: the
    losses, metrics, gradients and weights at that test's tolerances."""
    two, _, one = _two_vs_one("detr", tmp_path, DROP)
    for k in ("loss_ce", "class_error", "grad_norm"):
        np.testing.assert_allclose(two[k].numpy(), one[k].numpy(), rtol=1e-5, err_msg=k)
    for k in ("loss_ce", "top1", "top5"):
        np.testing.assert_allclose(float(two[f"eval.{k}"]), float(one[f"eval.{k}"]), rtol=1e-5)
    _grads_agree(two, one, 1e-4)
    trained = [k for k in one if not k.startswith(("grad.", "eval.", "loss_ce", "class_error",
                                                   "grad_norm", "backbone.0.body.conv1",
                                                   "backbone.0.body.bn1",
                                                   "backbone.0.body.layer1"))
               and one[k].is_floating_point()]
    _adam_weights_agree(two, one, trained, 1e-3, 2)


def test_caption_step_with_dropout_on_two_ranks_equals_one_rank(tmp_path):
    """``test_caption_step_on_two_ranks_equals_one_rank`` with the text
    tower's dropout at 0.1."""
    two, _, one = _two_vs_one("caption", tmp_path, DROP)
    np.testing.assert_allclose(two["losses"].numpy(), one["losses"].numpy(), rtol=1e-5)
    for k in ("loss", "i2t_top1", "i2t_top5", "t2i_top1", "t2i_top5"):
        np.testing.assert_allclose(float(two[f"eval.{k}"]), float(one[f"eval.{k}"]), rtol=1e-5)
    _grads_agree(two, one, 1e-4)
    _adam_weights_agree(two, one, [k for k in one if k.startswith(("image_head.", "text."))],
                        1e-3, 2)


def test_rls_step_with_dropout_on_two_ranks_equals_one_rank(tmp_path):
    """``test_rls_steps_on_two_ranks_equal_one_rank``'s RLS train step with
    the DETR's dropout at 0.1: the global loss and reward (1e-5), each
    rank's saccades and rewards its rows of the 1-rank rollout, the DETR
    weights as Adam allows."""
    two, ranks, one = _two_vs_one("rls", tmp_path, DROP)
    for k in ("train.loss_ce", "train.reward_mean", "train.grad_norm"):
        np.testing.assert_allclose(float(two[k]), float(one[k]), rtol=1e-5, err_msg=k)
    for r, out in enumerate(ranks):
        rows = slice(r * 4, (r + 1) * 4)
        assert torch.equal(out["saccades"], one["saccades"][rows])
        assert torch.equal(out["reward"], one["reward"][rows])
    detr = [k for k in one if k.startswith("detr.") and one[k].is_floating_point()]
    _adam_weights_agree(two, one, detr, 1e-3, 1)
