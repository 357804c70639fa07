"""The port's convergence cases at 2 steps (``tools/torch_convergence.py``).

The slow suite (``tests/test_torch_port_convergence.py``) and
``chip_smoke.py`` phase 3l run the seven cases in full and hold them to the
JAX package's thresholds. Here each case runs 2 steps (one eval) at its own
sizes on the CPU: its data equals the JAX test's bit for bit, it returns
finite numbers under every key its thresholds read, the same numbers twice
for one seed, and the port's SimCLR loop of the loss-curve parity tracks
``tools/loss_curve_parity.run_jax`` over 2 steps.

torch runs on one thread: the loss-curve test runs XLA in this process,
and after that torch's threaded CPU kernels now and then give one thread's
share of an elementwise op another result.
"""

import inspect
import math
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import test_convergence
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from tools import loss_curve_parity  # noqa: E402
from tools import torch_convergence as tc  # noqa: E402
from tools.torch_loss_curve_parity import compare  # noqa: E402

TWO_STEPS = {"simclr": dict(steps=2, evals=1), "probe": dict(steps=2, evals=1),
             "detr": dict(steps=2, evals=1), "dqn": dict(updates=2),
             "caption": dict(steps=2, evals=1, calibration=1), "captioner": dict(steps=2),
             # one step of each phase: the ring holds 8 rows, below the 48 an
             # update needs (dqn runs the update)
             "rls": dict(na=1, nb=1, evals=1)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)


def test_the_cases_import_neither_jax_nor_the_jax_package():
    """``chip_smoke.py`` imports the cases on a machine without JAX."""
    code = ("import sys; import tools.torch_convergence, tools.torch_fused_drift; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'multimodal_active_ai_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_structured_images_equal_the_jax_tests():
    for n, n_classes, seed in ((32, None, 0), (32, 4, 3), (8, 2, 5), (16, None, 0)):
        got = tc.structured_images(n, n_classes=n_classes, seed=seed)
        want = test_convergence.structured_images(n, n_classes=n_classes, seed=seed)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_stripe_images_equal_the_jax_tests():
    """The RLS test builds its images inline: its lines from the stripe
    comment to the batch size, run as they stand."""
    src = inspect.getsource(test_convergence.test_rls_policy_eval_beats_random_eval)
    lines = src.splitlines()
    first = next(i for i, ln in enumerate(lines) if "# vertical stripe" in ln)
    last = next(i for i, ln in enumerate(lines) if ln.strip().startswith("B = int("))
    scope = {"np": np, "jnp": jnp, "NCLS": 4}
    exec(textwrap.dedent("\n".join(lines[first:last])), scope)
    images, labels = tc.stripe_images(4)
    assert images.dtype == np.uint8 and np.array_equal(images, np.asarray(scope["images"]))
    assert np.array_equal(labels, np.asarray(scope["labels"]))


@pytest.mark.parametrize("case", sorted(tc.CASES))
def test_case_runs_two_steps_finite_and_deterministic(case):
    first = tc.CASES[case]("cpu", 0, **TWO_STEPS[case])
    for key in tc.keys_read(case):
        assert math.isfinite(first[key]), (key, first[key])
    assert first["losses"] and all(math.isfinite(x) for x in first["losses"])
    assert isinstance(tc.misses(case, first), list)
    assert tc.CASES[case]("cpu", 0, **TWO_STEPS[case]) == first


def test_same_state_steps_follow_case_one():
    """``simclr_same_state``: the reference is case 1's ``bn`` trajectory,
    draws included, bit for bit; each candidate step (``bn_fused``, the
    plain statistics on the CPU) starts from the reference's state, so the
    two losses agree to float32 rounding. (ResNet10 to keep it short.)"""
    r = tc.simclr_same_state("cpu", 0, steps=2, arch="ResNet10", norm_kind="bn_fused")
    assert r["reference"] == tc.simclr_case("cpu", 0, steps=2, evals=1, arch="ResNet10")["losses"]
    np.testing.assert_allclose(r["candidate"], r["reference"], rtol=1e-5)


def test_port_loop_tracks_run_jax_over_two_steps():
    views = (tc.view_stream(15, 2, 2, 8), loss_curve_parity.view_stream(15, 2, 2, 8))
    for t in range(2):
        assert np.array_equal(views[0](t), views[1](t))
    jax_curve, port_curve, worst = compare(steps=2, fixations=2, batch=8, verbose=False)
    assert len(port_curve) == len(jax_curve) == 4
    assert worst < 0.01, (jax_curve, port_curve)
