"""Optimizer construction: sgd / adam / lars / adamw / rmsprop.

Port of ``multimodal_active_ai_tpu/train/optimizers.py`` (reference
``SimCLR/Model_Util.py:68-88``), with the update arithmetic of the optax
chains the JAX package builds:

* ``sgd``: weight decay added to the gradient, then heavy-ball momentum
  (``optax.chain(add_decayed_weights, sgd(momentum))`` = ``torch.optim.SGD``
  with ``weight_decay`` and ``dampening=0``);
* ``adam``: ``torch.optim.Adam`` with optax's β = (0.9, 0.999), ε = 1e-8;
  with ``mu_dtype`` (``optax.adam(mu_dtype=)``) the first moment is kept in
  that dtype and the update computed in float32 (:class:`AdamMuDtype`);
* ``lars``: Adam wrapped in apex ``LARC`` (clip mode, trust coefficient
  η = 0.02): each parameter's Adam step is scaled by
  ``min(1, η·‖p‖ / (‖step‖ + 1e-8))`` when both norms are positive;
* ``adamw`` (the DETR driver's): ``optax.adamw`` decays every parameter,
  biases and LayerNorm included, by ``lr·wd·p`` on the pre-update value,
  which is ``torch.optim.AdamW`` with ε = 1e-8;
* ``rmsprop`` (the RLS driver's DQN optimizer): ``optax.rmsprop(lr)``, i.e.
  ``ν ← 0.9·ν + 0.1·g²`` from ``ν = 0`` and ``p ← p − lr·g·rsqrt(ν + ε)``
  with ε = 1e-8 **inside** the root, no momentum, no centring
  (:class:`RMSprop`). ``torch.optim.RMSprop`` differs by default (α = 0.99,
  ε outside the root).

The learning rate is set per update from the schedule by the trainer
(:func:`set_learning_rate`), as optax evaluates its schedule per update.

:func:`load_optax_state` carries a JAX package checkpoint's optax state
into these optimizers, the moments through the same weight maps as the
parameters.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch


class LARCAdam(torch.optim.Optimizer):
    """Adam with the apex-LARC adaptive trust ratio in clip mode
    (``optax.chain(scale_by_adam(), larc_scale(), scale_by_learning_rate)``)."""

    def __init__(self, params: Iterable, lr: float = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 trust_coefficient: float = 0.02, trust_eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      trust_coefficient=trust_coefficient,
                                      trust_eps=trust_eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("LARCAdam takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(b1).add_(p.grad, alpha=1 - b1)
                v.mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
                update = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + group["eps"])
                pn = torch.linalg.vector_norm(p)
                un = torch.linalg.vector_norm(update)
                ratio = torch.where((pn > 0) & (un > 0),
                                    group["trust_coefficient"] * pn / (un + group["trust_eps"]),
                                    1.0)
                p.add_(update * torch.clamp_max(ratio, 1.0), alpha=-group["lr"])


class AdamMuDtype(torch.optim.Optimizer):
    """optax's ``adam(mu_dtype=...)``: Adam whose first moment ``mu`` is
    stored in ``mu_dtype`` (bf16 halves one of the moment streams an update
    reads and writes). Each update follows ``optax.scale_by_adam`` step for
    step: ``mu ← (1 − β1)·g + β1·mu`` (``β1·mu`` in ``mu_dtype``, with β1
    itself rounded to ``mu_dtype`` as JAX's weak typing rounds the Python
    float: 0.8984375 in bf16; the sum in float32), ``ν ← (1 − β2)·g² +
    β2·ν`` in float32, the bias-corrected ratio ``μ̂ / (√ν̂ + ε)`` in
    float32, ``p ← p − lr·ratio``, and only then ``mu`` rounded to
    ``mu_dtype`` for storage."""

    def __init__(self, params: Iterable, lr: float = 1e-3, mu_dtype: torch.dtype = torch.bfloat16,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, mu_dtype=mu_dtype))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamMuDtype takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.to(torch.float32)
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p, dtype=group["mu_dtype"])
                    state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                state["step"] += 1
                t = state["step"]
                b1_mu = torch.tensor(b1, dtype=group["mu_dtype"]).item()
                mu = (1 - b1) * g + b1_mu * state["exp_avg"]
                nu = state["exp_avg_sq"]
                nu.copy_((1 - b2) * (g * g) + b2 * nu)
                update = (mu / (1 - b1 ** t)) / (torch.sqrt(nu / (1 - b2 ** t)) + group["eps"])
                p.add_(update.to(p.dtype), alpha=-group["lr"])
                state["exp_avg"].copy_(mu)


class RMSprop(torch.optim.Optimizer):
    """optax's ``rmsprop`` (``scale_by_rms`` then the learning rate):
    ``ν ← decay·ν + (1 − decay)·g²``, ``p ← p − lr·g·rsqrt(ν + ε)``."""

    def __init__(self, params: Iterable, lr: float = 1e-3, decay: float = 0.9,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RMSprop takes no closure")
        for group in self.param_groups:
            decay = group["decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["nu"] = torch.zeros_like(p)
                state["step"] += 1
                nu = state["nu"]
                nu.mul_(decay).addcmul_(p.grad, p.grad, value=1 - decay)
                p.add_(p.grad * torch.rsqrt(nu + group["eps"]), alpha=-group["lr"])


def get_optimizer(name: str, params: Iterable, momentum: float = 0.9,
                  weight_decay: float = 1e-4,
                  mu_dtype: torch.dtype | None = None,
                  fused: bool = False) -> torch.optim.Optimizer:
    """sgd / adam / lars / adamw / rmsprop with the reference's wiring (SGD
    takes momentum and weight decay, Adam, LARS and RMSprop only the
    learning rate, AdamW the weight decay). The initial learning rate is 0; the trainer sets it
    per update. ``mu_dtype`` (``adam`` only) keeps Adam's first moment in
    that dtype (:class:`AdamMuDtype`); no driver sets it, the bench's
    ``BENCH_ADAM_MU`` does. ``fused`` (``adamw`` only) takes torch's fused
    AdamW, one kernel over every tensor with no temporary the size of the
    parameters (the generative caption step sets it on a card)."""
    if fused and name != "adamw":
        raise ValueError(f"fused is an option of adamw, not of {name}")
    if mu_dtype is not None:
        if name != "adam":
            raise ValueError(f"mu_dtype is an option of adam, not of {name}")
        return AdamMuDtype(params, lr=0.0, mu_dtype=mu_dtype)
    if name == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=momentum,
                               weight_decay=weight_decay)
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    if name == "lars":
        return LARCAdam(params, lr=0.0)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay, fused=fused or None)
    if name == "rmsprop":
        return RMSprop(params, lr=0.0)
    raise ValueError(f"Unknown optimizer {name}")


def updates_taken(optimizer: torch.optim.Optimizer) -> int | None:
    """The update count an Adam-family or RMSprop optimizer keeps in its
    state (its ``step``), or None where the state holds none (SGD, or no
    update yet)."""
    for state in optimizer.state.values():
        if "step" in state:
            return int(state["step"])
    return None


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


# Where each optax chain of the JAX package keeps what the port's optimizer
# state holds, as ``flax.serialization.to_state_dict`` writes it (a chain's
# states under '0', '1', ...): the chain's keys, the moment trees by torch
# state key, the count bias correction reads, the count the schedule reads.
_OPTAX_LAYOUTS = {
    # optax.adam(sched) = chain(scale_by_adam, scale_by_learning_rate)
    "adam": (("0", "1"), {"exp_avg": ("0", "mu"), "exp_avg_sq": ("0", "nu")},
             ("0", "count"), ("1", "count")),
    # chain(scale_by_adam, larc_scale (EmptyState), scale_by_learning_rate)
    "lars": (("0", "1", "2"), {"exp_avg": ("0", "mu"), "exp_avg_sq": ("0", "nu")},
             ("0", "count"), ("2", "count")),
    # chain(add_decayed_weights, sgd = chain(trace, scale_by_learning_rate))
    "sgd": (("0", "1"), {"momentum_buffer": ("1", "0", "trace")}, None, ("1", "1", "count")),
    # optax.adamw(sched) = chain(scale_by_adam, add_decayed_weights, scale_by_learning_rate)
    "adamw": (("0", "1", "2"), {"exp_avg": ("0", "mu"), "exp_avg_sq": ("0", "nu")},
              ("0", "count"), ("2", "count")),
    # optax.rmsprop(lr) = chain(scale_by_rms, scale (empty), ...), no count
    "rmsprop": (("0", "1", "2"), {"nu": ("0", "nu")}, None, None),
}


def _at(tree, path: tuple[str, ...], what: str):
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            raise ValueError(f"the optax state has no '{'/'.join(path)}': it is not the "
                             f"state of the JAX package's {what} chain")
        tree = tree[key]
    return tree


def _check_keys(tree, keys, what: str) -> None:
    """The JAX package's ``restore_like`` refuses a state of another chain;
    so does the port."""
    # a chain's '0'…'10' in numeric order, never lexical
    got = sorted(tree, key=lambda k: (len(k), k)) if isinstance(tree, dict) else tree
    if not isinstance(tree, dict) or list(got) != list(keys):
        raise ValueError(f"the optax state {got!r} is not the JAX package's {what} chain "
                         f"(states {list(keys)})")


def _load_chain(optimizer: torch.optim.Optimizer, groups, chain: dict, kind: str,
                mapped: Callable[[dict], dict], names: dict) -> int | None:
    """Fill the state of every parameter of ``groups`` from one optax chain
    of layout ``kind``; returns the count its schedule reads."""
    keys, moments, bias_path, sched_path = _OPTAX_LAYOUTS[kind]
    _check_keys(chain, keys, kind)
    trees = {k: mapped(_at(chain, path, kind)) for k, path in moments.items()}
    bias = int(np.asarray(_at(chain, bias_path, kind))) if bias_path else None
    sched = int(np.asarray(_at(chain, sched_path, kind))) if sched_path else None
    want = sorted(names.values())
    for key, tree in trees.items():
        if sorted(tree) != want:
            raise ValueError(f"the optax {key} tree does not cover this model's parameters: "
                             f"{sorted(set(tree) ^ set(want))[:4]} differ")
    for group in groups:
        for p in group["params"]:
            state = {}
            for key, tree in trees.items():
                value = tree[names[p]]
                if tuple(value.shape) != tuple(p.shape):
                    raise ValueError(f"optax {key} of {names[p]}: {tuple(value.shape)} "
                                     f"vs the parameter's {tuple(p.shape)}")
                state[key] = torch.empty_like(p).copy_(value)
            if kind in ("adam", "adamw"):
                state["step"] = torch.tensor(float(bias), dtype=torch.float32)
            elif kind == "lars":
                state["step"] = bias
            elif kind == "rmsprop":
                state["step"] = 0
            optimizer.state[p] = state
    return sched


def load_optax_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                     opt_state: dict, kind: str, to_port: Callable[[dict], dict],
                     clipped: bool = False) -> int | None:
    """Carry the JAX package's optax state into ``optimizer``.

    ``opt_state`` is the state as ``flax.serialization.to_state_dict``
    writes it and the port's msgpack reader returns it; ``kind`` the
    :func:`get_optimizer` name it was built by, or ``'detr'`` for the DETR
    driver's ``[clip_by_global_norm →] multi_transform({head, backbone:
    adamw, frozen: set_to_zero})`` (``clipped``: with the clip, which
    keeps no state), whose groups are matched to the optimizer's
    ``param_groups`` by their ``name``. ``to_port`` maps a tree in the JAX
    parameters' layout to ``{parameter name in model: tensor}`` (the
    driver's weight map, parameters only): Adam's ``mu``/``nu``, SGD's
    ``trace`` and RMSprop's ``nu`` go through it, and so must be pure
    reorderings of the parameters. The moments and the count that bias
    correction reads land bit for bit (``step`` a float32 tensor for
    ``torch.optim.Adam``/``AdamW``, an int for ``LARCAdam``); RMSprop's
    ``step`` restarts at 0, optax's rmsprop keeping none. A state of
    another chain, or moments that do not cover the parameters, raise
    ``ValueError``, as the JAX package's ``restore_like`` refuses them.

    Returns optax's schedule ``count`` (None for rmsprop, whose rate is
    constant): the trainer's ``TrainState.count``.
    """
    names = {p: n for n, p in model.named_parameters()}
    if kind != "detr":
        return _load_chain(optimizer, optimizer.param_groups, opt_state, kind, to_port, names)
    tree = opt_state
    if clipped:
        _check_keys(tree, ("0", "1"), "clip_by_global_norm → multi_transform")
        tree = tree["1"]
    inner = _at(tree, ("inner_states",), "DETR multi_transform")
    if sorted(inner) != ["backbone", "frozen", "head"] or _at(
            inner, ("frozen", "inner_state"), "DETR multi_transform") != {}:
        raise ValueError(f"the optax state's groups {sorted(inner)} are not the DETR "
                         "optimizer's head/backbone/frozen")
    counts = set()
    for group in optimizer.param_groups:
        chain = _at(inner, (group["name"], "inner_state"), "DETR multi_transform")
        counts.add(_load_chain(optimizer, [group], chain, "adamw", to_port, names))
    if len(counts) != 1:
        raise ValueError(f"the DETR groups' schedule counts differ: {sorted(counts)}")
    return counts.pop()
