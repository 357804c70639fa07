"""Rank-side cases of the port's data-parallel tests, and their launcher.

Each case is a function of its global inputs (a dict of tensors) that runs
on this rank's rows and returns a dict of tensors. :func:`run_ranks` runs a
case as a real ``world``-process gloo job on the CPU (the port's
``initialize_distributed`` reading the JAX package's ``MAAI_*`` variables,
with a ``file://`` rendezvous in the test's directory), and
:func:`run_local` runs it in the calling process without a process group:
the port's 1-rank result on the whole global batch. Every draw, dropout
included, comes from a generator seeded in the case; torch's global
generator is never seeded, so nothing can depend on it. The DETR, caption
and RLS cases take ``inp["dropout"]`` (0 by default). The module imports no
JAX, so a rank starts in about two seconds::

    python tests/torch_port_distributed_cases.py CASE IN.pt OUT.pt

(with ``MAAI_NUM_PROCESSES``, ``MAAI_COORDINATOR``, ``MAAI_PROCESS_ID`` set;
each rank writes ``OUT.pt.<rank>``).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

from multimodal_active_ai_tpu_torch import parallel
from multimodal_active_ai_tpu_torch.models.detr import DETR
from multimodal_active_ai_tpu_torch.models.mlp import LogisticRegression
from multimodal_active_ai_tpu_torch.models.norm import SyncBatchNorm
from multimodal_active_ai_tpu_torch.models.qnet import build_dqn
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
from multimodal_active_ai_tpu_torch.models.text import TextEncoder
from multimodal_active_ai_tpu_torch.objectives.ntxent import contrastive_loss
from multimodal_active_ai_tpu_torch.objectives.set_criterion import SetCriterion
from multimodal_active_ai_tpu_torch.ops import bn_act, retina
from multimodal_active_ai_tpu_torch.parallel import collectives, local_rows
from multimodal_active_ai_tpu_torch.rl.replay_memory import Transition
from multimodal_active_ai_tpu_torch.train import (caption_probe, detr_train, eval_probe,
                                                  optimizers, rls_train, schedule, simclr_train)
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState

GEOM = dict(canvas_size=64, glimpse_size=30, crop_sizes=(40, 24, 10, 30))
DETR_SMALL = dict(num_queries=5, hidden_dim=32, nheads=2, enc_layers=1, dec_layers=1,
                  dim_feedforward=64, dropout=0.0)
CLASSES, F, A = 10, 3, 10
HERE = os.path.dirname(os.path.abspath(__file__))


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _images(n: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3),
                                                                 dtype=np.uint8))


def _grads(model: torch.nn.Module) -> dict:
    """The gradients a step left in ``.grad`` (averaged, clipped or
    clamped as the step's update saw them)."""
    return {f"grad.{k}": p.grad.clone() for k, p in model.named_parameters()
            if p.grad is not None}


def _weights(model: torch.nn.Module, prefix: str = "") -> dict:
    return {f"{prefix}{k}": v.clone() for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------------
# collectives, SyncBatchNorm, NT-Xent


def case_concat(inp: dict) -> dict:
    """``cross_replica_concat`` (local block differentiable, and not) and
    ``all_gather_with_grad`` under the loss ``Σ gathered · W[rank]``."""
    r = parallel.rank()
    out = {}
    for name in ("local", "detached", "full"):
        x = local_rows(inp["x"]).clone().requires_grad_(True)
        if name == "full":
            y = parallel.all_gather_with_grad(x)
        else:
            y = parallel.cross_replica_concat(x, differentiable_local=name == "local")
        out[f"{name}.y"] = y.detach().clone()
        if y.requires_grad:
            (y * inp["w"][r]).sum().backward()
            out[f"{name}.grad"] = x.grad
    return out


def case_syncbn(inp: dict) -> dict:
    """``SyncBatchNorm`` (``bn`` without a group) in train mode under the
    loss ``Σ y · G``: output, input gradient, the affine gradients summed
    over ranks (the loss is a sum over every rank's rows) and the running
    statistics."""
    bn = SyncBatchNorm(inp["x"].shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(inp["weight"])
        bn.bias.copy_(inp["bias"])
    x = local_rows(inp["x"]).clone().requires_grad_(True)
    y = bn(x)
    (y * local_rows(inp["g"])).sum().backward()
    return {"y": y.detach(), "x.grad": x.grad,
            "weight.grad": parallel.all_reduce_sum(bn.weight.grad),
            "bias.grad": parallel.all_reduce_sum(bn.bias.grad),
            "running_mean": bn.running_mean, "running_var": bn.running_var}


# the fused BatchNorm's kernel wrappers and the plain versions that stand in
# for them on the CPU (the same arguments; the gradient pass's outputs as
# wanted, its divisor the count in the forward's sums)
def _grad_apply_plain(g, x, y, stats, weight, dw, db, sums, want_dx=True, want_identity=False):
    count = sums[2 * x.shape[1]:]
    dx, gy = bn_act.bn_act_grad_apply_plain(g, x, y, stats, weight, dw, db, count)
    return dx if want_dx else None, gy if want_identity else None


SYNC_BN_PLAIN = {"bn_act_sums": bn_act.bn_act_sums_plain,
                 "bn_act_apply": bn_act.bn_act_apply_plain,
                 "bn_act_grad_sums": bn_act.bn_act_grad_sums_plain,
                 "bn_act_grad_apply": _grad_apply_plain}


def _fused_sync_bn(x, bn, identity=None, relu=True):
    """``bn_act``'s Function over every rank's rows, on the CPU: the
    Function itself, which ``batch_norm_act`` hands CUDA tensors alone."""
    return bn_act._BatchNormAct.apply(x, bn.weight, bn.bias, identity, bn.running_mean,
                                      bn.running_var, bn.num_batches_tracked, bn.momentum, bn.eps,
                                      relu, True)


def _syncbn_module(inp: dict) -> SyncBatchNorm:
    bn = SyncBatchNorm(inp["x"].shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(inp["weight"])
        bn.bias.copy_(inp["bias"])
        bn.running_mean.copy_(inp["running_mean"])
        bn.running_var.copy_(inp["running_var"])
    return bn


def _syncbn_side(inp: dict, x: torch.Tensor, identity: torch.Tensor | None, relu: bool,
                 fused: bool) -> dict:
    """``relu?(sync_bn(x) [+ identity])`` of this rank's rows under the loss
    ``Σ y · G``, by ``SyncBatchNorm``'s chain or by ``bn_act``'s sync
    Function: output, gradients and buffers."""
    bn = _syncbn_module(inp)
    x = x.clone().requires_grad_(True)
    identity = None if identity is None else identity.clone().requires_grad_(True)
    if fused:
        y = _fused_sync_bn(x, bn, identity, relu)
    else:
        y = bn(x)
        y = y if identity is None else y + identity
        y = torch.relu(y) if relu else y
    (y * local_rows(inp["g"])[:x.shape[0]]).sum().backward()
    out = {"y": y.detach(), "x.grad": x.grad, "weight.grad": bn.weight.grad,
           "bias.grad": bn.bias.grad, **{k: v.clone() for k, v in bn.named_buffers()}}
    if identity is not None:
        out["identity.grad"] = identity.grad
    return out


def case_syncbn_fused(inp: dict) -> dict:
    """The fused ``sync_bn`` Function of ``ops/bn_act.py`` with the plain
    versions standing in for its kernels, beside ``SyncBatchNorm``'s chain,
    on this rank's rows: with and without the residual and the ReLU
    (``x``); on ``x_clamp``, whose last channels' one-pass variance falls
    below 0 (both sides' clamp flags of the global statistics returned);
    and with rank 0 holding one row fewer than the others (``uneven``).
    Then the ``collectives.sum`` calls of one forward and backward (ReLU, no
    residual) when only rank 0's input needs a gradient."""
    saved = {k: getattr(bn_act, k) for k in SYNC_BN_PLAIN}
    out = {}
    try:
        for k, v in SYNC_BN_PLAIN.items():
            setattr(bn_act, k, v)
        identity = local_rows(inp["identity"])
        for name, xs, with_id, relu in (("id.relu", "x", True, True), ("id", "x", True, False),
                                        ("relu", "x", False, True), ("plain", "x", False, False),
                                        ("clamp", "x_clamp", False, True),
                                        ("uneven", "x", False, True)):
            x = local_rows(inp[xs])
            if name == "uneven" and parallel.rank() == 0:
                x = x[:-1]
            for side in ("chain", "fused"):
                got = _syncbn_side(inp, x, identity if with_id else None, relu, side == "fused")
                out.update({f"{name}.{side}.{k}": v for k, v in got.items()})
            if name == "clamp":
                xf = x.to(torch.float32)
                dims = [0, 2, 3]
                s, sq, n = SyncBatchNorm.global_sums(xf.sum(dims), (xf * xf).sum(dims),
                                                     x.numel() // x.shape[1])
                mean = s / n
                out["clamp.chain.flag"] = (sq / n - mean * mean < 0).to(torch.float32)
                sums = parallel.all_reduce_sum(bn_act.bn_act_sums_plain(bn_act._rows(x)))
                out["clamp.fused.flag"] = bn_act.stats_from_sums_plain(sums, 1e-5)[0][2]
        bn = _syncbn_module(inp)
        x = local_rows(inp["x"]).clone().requires_grad_(parallel.rank() == 0)
        before = collectives.counts()["collectives.sum"][0]
        y = _fused_sync_bn(x, bn)
        (y * local_rows(inp["g"])).sum().backward()
        out["sum_calls"] = torch.tensor(collectives.counts()["collectives.sum"][0] - before)
        out["no_input_grad.weight.grad"] = bn.weight.grad
    finally:
        for k, v in saved.items():
            setattr(bn_act, k, v)
    return out


def case_ntxent(inp: dict) -> dict:
    """NT-Xent of this rank's rows (negatives from every rank) in both
    gather semantics: loss, ``logits_ab``, labels and both inputs'
    gradients of this rank's loss."""
    out = {}
    for tgs in (True, False):
        h1 = local_rows(inp["h1"]).clone().requires_grad_(True)
        h2 = local_rows(inp["h2"]).clone().requires_grad_(True)
        loss, logits_ab, labels = contrastive_loss(h1, h2, temperature=float(inp["t"]),
                                                   torch_gather_semantics=tgs)
        loss.backward()
        out.update({f"{tgs}.loss": loss.detach(), f"{tgs}.logits_ab": logits_ab.detach(),
                    f"{tgs}.labels": labels, f"{tgs}.h1.grad": h1.grad,
                    f"{tgs}.h2.grad": h2.grad})
    return out


# ---------------------------------------------------------------------------
# the SimCLR step


def case_simclr(inp: dict) -> dict:
    """The SimCLR train step (ResNet10, float32, Adam) from ``inp["sd"]``:
    on the given global draws (``params``/``noise``, per view) and on the
    step's own draws from a seeded generator; then the eval step."""
    cfg = retina.RetinaConfig(**GEOM)
    norm = "sync_bn" if parallel.world_size() > 1 else "bn"
    images = local_rows(inp["images"])
    nf = int(inp["num_fixations"])
    # the first view the generator run draws: this rank's rows of the global view
    out = {"view0": simclr_train._view_fn(images, cfg, _gen(7), None, None)(0)}
    for drawn in ("given", "generator"):
        model = SimCLRModule(arch="ResNet10", norm_kind=norm)
        model.load_state_dict(inp["sd"])
        state = TrainState(model, optimizers.get_optimizer("adam", model.parameters()),
                           schedule.simclr_learning_rate(*inp["lr_args"].tolist()))
        step = simclr_train.make_train_step(cfg, nf, float(inp["t"]))
        if drawn == "given":
            params = [retina.AugParams(*map(local_rows, p)) for p in inp["params"]]
            noise = [local_rows(n) for n in inp["noise"]]
            losses = step(state, images, params=params, noise=noise)
        else:
            losses = step(state, images, _gen(7))
        ev = simclr_train.make_eval_step(cfg, float(inp["t"]))(state, images, _gen(8))
        out.update({f"{drawn}.losses": losses, **_weights(model, f"{drawn}.sd."),
                    **{f"{drawn}.eval.{k}": v for k, v in ev.items()}})
    return out


# ---------------------------------------------------------------------------
# the downstream steps (the port's own seeded weights and draws)


def case_probe(inp: dict) -> dict:
    """Two probe train steps (SGD with momentum) on a frozen random
    ResNet10 encoder, then the eval step, drawing fixations from a seeded
    generator."""
    cfg = retina.RetinaConfig(**GEOM)
    encoder = SimCLRModule(arch="ResNet10", generator=_gen(0))
    probe = LogisticRegression(512 * 16 * 2, CLASSES, generator=_gen(1))
    state = TrainState(probe, optimizers.get_optimizer("sgd", probe.parameters()),
                       lambda _: 0.05)
    images, labels = local_rows(_images(8, 2)), local_rows(torch.arange(8) % CLASSES)
    step = eval_probe.make_probe_train_step(cfg, 2)
    gen = _gen(3)
    ms = [step(state, encoder, images, labels, gen) for _ in range(2)]
    ev = eval_probe.make_probe_eval_step(cfg, 2)(state, encoder, images, labels, gen)
    return {"losses": torch.stack([m["loss"] for m in ms]), **_grads(probe),
            **_weights(probe), **{f"eval.{k}": v for k, v in ev.items()}}


def _detr(sd=None, dropout: float = 0.0) -> DETR:
    model = DETR("ResNet10", CLASSES, **{**DETR_SMALL, "dropout": dropout}, generator=_gen(4))
    if sd is not None:
        model.load_state_dict(sd)
    return model


def case_detr(inp: dict) -> dict:
    """Two DETR train steps (AdamW groups, StepLR, an active clip) from a
    seeded model on the step's own draws, then the eval step; and, when
    ``inp`` holds JAX weights and draws, one plain-SGD step on those draws
    (the JAX mesh test's configuration)."""
    cfg = retina.RetinaConfig(**GEOM)
    crit = SetCriterion(DETR_SMALL["num_queries"], CLASSES)
    images, labels = local_rows(_images(8, 5)), local_rows(torch.arange(8) % CLASSES)
    model = _detr(dropout=float(inp.get("dropout", 0.0)))
    state = TrainState(model, detr_train.make_detr_optimizer(model, 1e-3, 1e-4, 1e-4,
                                                             pretrained_backbone=True),
                       detr_train.step_lr(1, 1))
    step = detr_train.make_detr_train_step(crit, cfg, F, 0.1)
    gen, drop = _gen(6), _gen(19)
    ms = [step(state, images, labels, gen, dropout_generator=drop) for _ in range(2)]
    ev = detr_train.make_detr_eval_step(crit, cfg, F)(state, images, labels, gen)
    out = {**{f"{k}": torch.stack([m[k] for m in ms]) for k in ms[0]}, **_grads(model),
           **_weights(model), **{f"eval.{k}": v for k, v in ev.items()}}
    if "jax_sd" in inp:
        model = _detr(inp["jax_sd"])
        opt = torch.optim.SGD([{"params": list(model.parameters()), "base_lr": 0.05}], lr=0.05)
        state = TrainState(model, opt, lambda _: 1.0)
        step_sgd = detr_train.make_detr_train_step(crit, cfg, int(inp["jax_f"]), 0.0)
        m = step_sgd(state, local_rows(inp["jax_images"]), local_rows(inp["jax_labels"]),
                     num_fixs=int(inp["jax_num_fixs"]),
                     saccades=local_rows(inp["jax_saccades"]))
        out.update({"jax.loss_ce": m["loss_ce"], **_weights(model, "jax.sd.")})
    return out


def case_caption(inp: dict) -> dict:
    """Two caption-probe train steps (Adam, the symmetric InfoNCE with both
    towers' gradient) and the eval step, on a frozen random encoder, a
    small text tower (dropout ``inp["dropout"]``, 0 by default) and hashed
    template captions."""
    cfg = retina.RetinaConfig(**GEOM)
    encoder = SimCLRModule(arch="ResNet10", generator=_gen(0))
    g = _gen(9)
    text = TextEncoder(vocab_size=64, d_model=32, nhead=2, num_layers=1, dim_feedforward=64,
                       out_dim=16, dropout=float(inp.get("dropout", 0.0)), generator=g)
    towers = caption_probe.CaptionTowers(512 * 16 * 2, text, hidden_dim=64, out_dim=16,
                                         generator=g)
    state = TrainState(towers, optimizers.get_optimizer("adam", towers.parameters()),
                       lambda _: 1e-3)
    images = local_rows(_images(8, 10))
    tokens = local_rows(torch.from_numpy(np.random.default_rng(11).integers(1, 64, (8, 6))))
    step = caption_probe.make_caption_probe_train_step(cfg, 2, 0.05)
    gen, drop = _gen(12), _gen(20)
    ms = [step(state, encoder, images, tokens, gen, dropout_generator=drop) for _ in range(2)]
    ev = caption_probe.make_caption_probe_eval_step(cfg, 2, 0.05)(state, encoder, images,
                                                                  tokens, gen)
    return {"losses": torch.stack([m["loss"] for m in ms]), **_grads(towers),
            **_weights(towers), **{f"eval.{k}": v for k, v in ev.items()}}


def case_rls(inp: dict) -> dict:
    """One RLS train step at an epoch where the policy picks saccades (ε =
    0 after epoch 0), both eval steps, then one DQN update on a global
    replay batch of 8 (each rank its 4 rows): the policy's ``sync_bn``
    statistics, its clamped averaged gradient, RMSprop."""
    cfg = retina.RetinaConfig(**GEOM)
    crit = SetCriterion(DETR_SMALL["num_queries"], CLASSES)
    norm = "sync_bn" if parallel.world_size() > 1 else "bn"
    model = _detr(dropout=float(inp.get("dropout", 0.0)))
    policy = build_dqn("ResNet10", A, norm_kind=norm, generator=_gen(13))
    target = build_dqn("ResNet10", A, norm_kind=norm, generator=_gen(14))
    state = TrainState(model, detr_train.make_detr_optimizer(model, 1e-3, 1e-4, 1e-4,
                                                             pretrained_backbone=True),
                       detr_train.step_lr(1, 1))
    pstate = TrainState(policy, optimizers.get_optimizer("rmsprop", policy.parameters()),
                        lambda _: 1e-3)
    images, labels = local_rows(_images(8, 15)), local_rows(torch.arange(8) % CLASSES)
    eps = dict(eps_start=0.0, eps_end=0.0, eps_decay=1.0)
    gen, host = _gen(16), _gen(17)
    draws = rls_train.draw_rollout(gen, host, images.shape[0], F, _gen(21))
    m, ro, reward = rls_train.make_rls_train_step(crit, cfg, F, A, **eps, clip_max_norm=0.1)(
        state, policy, images, labels, 1, draws)
    out = {f"train.{k}": v for k, v in m.items()}
    out.update({"reward": reward, "saccades": ro.saccades, **_weights(model, "detr.")})
    vdraws = rls_train.draw_rollout(gen, host, images.shape[0], F)
    for greedy in (False, True):
        ev = rls_train.make_policy_eval_step(crit, cfg, F, A, greedy=greedy)(
            state, policy, images, labels, vdraws)
        out.update({f"eval.{greedy}.{k}": v for k, v in ev.items()})
    rng = np.random.default_rng(18)
    tr = Transition(*(local_rows(torch.from_numpy(a)) for a in (
        rng.uniform(0, 255, (8, 30, 30, 12)).astype(np.float32),
        rng.integers(0, A, (8, 2)).astype(np.float32) / A,
        rng.uniform(0, 255, (8, 30, 30, 12)).astype(np.float32),
        rng.integers(0, 2, (8,)).astype(np.float32))))
    loss = rls_train.make_dqn_update_step(A, 0.9)(pstate, target, tr)
    out.update({"dqn.loss": loss, **_grads(policy), **_weights(policy, "dqn.")})
    return out


# ---------------------------------------------------------------------------
# the collectives' counters and spans


def case_spans(inp: dict) -> dict:
    """One SimCLR train step (ResNet10, ``sync_bn`` at more than one rank,
    F = 2, float32) under a CPU profiler: the collectives' ``(calls,
    bytes)`` over the step, the number of ranges of each span name, and
    the parameters' element count (the gradient all-reduce's payload)."""
    cfg = retina.RetinaConfig(**GEOM)
    norm = "sync_bn" if parallel.world_size() > 1 else "bn"
    model = SimCLRModule(arch="ResNet10", norm_kind=norm, generator=_gen(1))
    state = TrainState(model, optimizers.get_optimizer("adam", model.parameters()),
                       lambda _: 1e-3)
    step = simclr_train.make_train_step(cfg, 2, 0.5)
    images = local_rows(_images(8, 3))
    collectives.reset_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, images, _gen(7))
    spans: dict = {}
    for e in prof.events():
        if e.is_user_annotation:
            spans[e.name] = spans.get(e.name, 0) + 1
    return {"counts": collectives.counts(), "spans": spans, "line": collectives.stats_line(2),
            "params": sum(p.numel() for p in model.parameters())}


CASES = {"concat": case_concat, "syncbn": case_syncbn, "syncbn_fused": case_syncbn_fused,
         "ntxent": case_ntxent,
         "simclr": case_simclr, "probe": case_probe, "detr": case_detr,
         "caption": case_caption, "rls": case_rls, "spans": case_spans}


def run_local(case: str, inputs: dict | None = None) -> dict:
    """The case in this process, without a process group: the 1-rank run
    on the whole global batch."""
    return CASES[case](inputs or {})


def run_ranks(case: str, tmp_path, inputs: dict | None = None, world: int = 2,
              timeout: float = 240.0) -> list[dict]:
    """The case as a ``world``-process gloo job on the CPU; each rank's
    outputs, in rank order. A rank that fails, or a job that outlives
    ``timeout`` seconds (a hung rendezvous), fails the calling test; no
    process outlives the call."""
    tmp_path = str(tmp_path)
    inp, out = os.path.join(tmp_path, f"{case}.in.pt"), os.path.join(tmp_path, f"{case}.out.pt")
    torch.save(inputs or {}, inp)
    rendezvous = os.path.join(tmp_path, f"{case}.rendezvous")
    env = {**os.environ, "MAAI_NUM_PROCESSES": str(world),
           "MAAI_COORDINATOR": f"file://{rendezvous}", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, os.path.basename(__file__)),
                               case, inp, out], env={**env, "MAAI_PROCESS_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {case} failed:\n{log[-3000:]}"
    outs = [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]
    for f in [inp] + [f"{out}.{r}" for r in range(world)]:
        os.remove(f)
    return outs


def run_driver(driver: str, args: list[str], cwds: list, world: int = 2,
               timeout: float = 300.0) -> list[tuple[int, str]]:
    """``python -m multimodal_active_ai_tpu_torch.<driver> args`` as a
    ``world``-process job on the CPU, rank ``r`` in the directory
    ``cwds[r]`` (so a relative ``--checkpoint-dir`` tells the ranks' writes
    apart). Returns each rank's ``(exit code, output)``; no process
    outlives the call, and a job that outlives ``timeout`` seconds fails the
    calling test."""
    rendezvous = os.path.join(str(cwds[0]), "rendezvous")
    env = {**os.environ, "MAAI_NUM_PROCESSES": str(world),
           "MAAI_COORDINATOR": f"file://{rendezvous}", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, "-m", f"multimodal_active_ai_tpu_torch.{driver}",
                               *args], cwd=str(cwds[r]), env={**env, "MAAI_PROCESS_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    return [(p.returncode, log) for p, log in zip(procs, logs)]


def _main() -> None:
    case, inp, out = sys.argv[1:4]
    torch.set_num_threads(1)
    parallel.initialize_distributed("cpu")
    try:
        result = CASES[case](torch.load(inp, weights_only=False))
        torch.save(result, f"{out}.{parallel.rank()}")
    finally:
        parallel.shutdown()


if __name__ == "__main__":
    _main()
