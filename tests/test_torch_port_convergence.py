"""Convergence suite of the port: each training path learns (slow).

The seven cases of ``tests/test_convergence.py`` on the port's step
functions (``tools/torch_convergence.py``), on the CPU, at the JAX test's
sizes and step counts, each held to the JAX test's thresholds; and the
port's SimCLR loss curve against the JAX package's over 8 steps (b=16,
F=2, the sizes of ``tests/test_loss_curve_parity.py``), within 1%.
``chip_smoke.py`` phase 3l runs the same cases on the card.

Run:  python -m pytest tests/test_torch_port_convergence.py -m slow -q
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from tools import torch_convergence as tc  # noqa: E402
from tools.torch_loss_curve_parity import compare  # noqa: E402

pytestmark = pytest.mark.slow


@pytest.mark.parametrize("case", list(tc.CASES))
def test_case_meets_the_jax_thresholds(case):
    result = tc.CASES[case]("cpu", 0)
    print(case, {k: v for k, v in result.items() if not isinstance(v, list)})
    assert tc.misses(case, result) == [], result


def test_loss_curve_tracks_the_jax_package():
    _, _, worst = compare(steps=8, fixations=2, batch=16, verbose=False)
    assert worst < 0.01, f"loss curves diverged: max rel diff {worst:.4f}"
