#!/usr/bin/env python
"""The RLS convergence case at several seeds, on both packages.

For each seed ``s``, three runs of case 7 of ``tests/test_convergence.py``
(learned saccades against random ones, the thresholds policy ≥ random + 0.2
and policy ≥ 0.85):

1. ``port``: ``tools/torch_convergence.rls_case("cpu", s)``, the port on
   its own weights and draws;
2. ``port, JAX draws``: the same case from the JAX test's initial DETR and
   DQN weights at ``PRNGKey(s)`` (through ``from_jax_detr_variables`` and
   ``from_jax_dqn_variables``) and on the rollout draws its step keys give,
   so that only the arithmetic differs from the JAX run;
3. ``JAX``: the JAX test itself at ``PRNGKey(s)`` with its replay ring
   seeded ``s`` (its source as it stands, with those two literals and its
   asserts replaced, run here).

The ports' rings are seeded ``s`` too, so at ``s = 0`` run 3 is the JAX test
as it stands. It tells draw luck (run 1 misses, run 2 passes) from a fault
of the port (runs 1 and 2 miss where run 3 passes).

Run:  MAAI_PLATFORM=cpu python tools/torch_rls_seeds.py [--seeds 0,1,2]
(torch on one thread: XLA runs in the same process.)
"""

from __future__ import annotations

import argparse
import inspect
import os
import sys
import textwrap
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tools import torch_convergence as tc  # noqa: E402

A, F, B, CLASSES, NA, NB, EVALS = 10, 3, 8, 4, 130, 80, 4


def jax_draws(key):
    """The draws the JAX rollout takes from ``key`` (``make_rollout``:
    ``k_n``/``k_loop``, then ``k_coin``/``k_rand``/``k_ret`` per fixation),
    as the port's :class:`RolloutDraws`."""
    import jax

    from multimodal_active_ai_tpu_torch.train.rls_train import RolloutDraws

    k_n, k_loop = jax.random.split(key)
    num_fixs = int(jax.random.randint(k_n, (), 2, max(F, 3)))
    coins, fixes = [], []
    for kj in jax.random.split(k_loop, F):
        k_coin, k_rand, _ = jax.random.split(kj, 3)
        coins.append(float(jax.random.uniform(k_coin, ())))
        fixes.append(np.asarray(jax.random.uniform(k_rand, (B, 2))))
    return RolloutDraws(num_fixs, tuple(coins), torch.from_numpy(np.stack(fixes)))


def jax_init_and_draws(seed):
    """The JAX test's initial DETR and DQN weights as port state dicts, and
    its ``NA + NB`` train-step and ``EVALS`` eval draws."""
    import jax
    import jax.numpy as jnp

    from multimodal_active_ai_tpu.models.detr import DETR
    from multimodal_active_ai_tpu.models.qnet import build_dqn
    from multimodal_active_ai_tpu_torch.utils.checkpoint import (from_jax_detr_variables,
                                                                 from_jax_dqn_variables)

    rng = jax.random.PRNGKey(seed)
    model = DETR(backbone_arch="ResNet18", num_classes=CLASSES, num_queries=4, hidden_dim=32,
                 nheads=2, enc_layers=1, dec_layers=1, dim_feedforward=64, dropout=0.0)
    v = model.init(rng, jnp.ones((2, F, 30, 30, 12)), jnp.full((2, F, 2), 0.5))
    dqn = build_dqn("ResNet18", num_of_actions=A, norm_kind="bn", axis_name=None)
    dv = dqn.init(jax.random.fold_in(rng, 1), jnp.ones((2, 30, 30, 12)))
    init = (from_jax_detr_variables(v["params"], v["batch_stats"]),
            from_jax_dqn_variables(dv["params"], dv["batch_stats"]))
    keys = jax.device_get(jax.random.split(rng, NA + NB + 16))
    # a train step hands its rollout the first half of its key, an eval step the key
    draws = ([jax_draws(jax.random.split(keys[i])[0]) for i in range(NA + NB)]
             + [jax_draws(keys[NA + NB + j]) for j in range(EVALS)])
    return init, draws


def jax_test(seed):
    """``(policy, random)`` of the JAX test at ``PRNGKey(seed)``, ring seeded
    ``seed``."""
    import test_convergence

    src = textwrap.dedent(inspect.getsource(
        test_convergence.test_rls_policy_eval_beats_random_eval))
    for old, new in (("rng = jax.random.PRNGKey(0)", f"rng = jax.random.PRNGKey({seed})"),
                     ("ReplayMemory(2048, (30, 30, 12))",
                      f"ReplayMemory(2048, (30, 30, 12), seed={seed})"),
                     ("assert pol >= rnd + 0.2, (pol, rnd)", "return float(pol), float(rnd)")):
        if src.count(old) != 1:
            raise RuntimeError(f"the JAX test's source no longer holds {old!r}")
        src = src.replace(old, new)
    scope = dict(vars(test_convergence))
    exec(src, scope)
    return scope["test_rls_policy_eval_beats_random_eval"]()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1,2")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    for seed in (int(s) for s in args.seeds.split(",")):
        rows = {}
        t0 = time.perf_counter()
        r = tc.rls_case("cpu", seed)
        rows["port"] = (r["policy"], r["random"], time.perf_counter() - t0)
        t0 = time.perf_counter()
        init, draws = jax_init_and_draws(seed)
        r = tc.rls_case("cpu", seed, init=init, draws=draws)
        rows["port, JAX draws"] = (r["policy"], r["random"], time.perf_counter() - t0)
        t0 = time.perf_counter()
        pol, rnd = jax_test(seed)
        rows["JAX"] = (pol, rnd, time.perf_counter() - t0)
        for label, (pol, rnd, secs) in rows.items():
            missed = tc.misses("rls", {"policy": pol, "random": rnd})
            print(f"seed {seed} {label:16s} policy {pol:.4f} random {rnd:.4f} "
                  f"{'met' if not missed else 'MISSED ' + '; '.join(missed)} ({secs:.0f} s)",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
