"""The port's bench, ``multimodal_active_ai_tpu_torch.bench``, against the
repository root's ``bench.py``, and Adam's ``mu_dtype`` against optax.

Each mode runs in-process on the CPU at the CPU defaults (b=4, canvas 64,
2 steps, ResNet18) with one window and the module's clock advancing 1 s a
call, so a window lasts 1 s and ``value`` is the units of one window. The
metric names and the record's and ``config``'s keys are read from
``bench.py`` with ``ast`` (nothing of it is imported). The slow tests run
``bench.py`` itself under ``JAX_PLATFORMS=cpu`` and hold its record to the
port's, mode by mode.
"""

import ast
import itertools
import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from multimodal_active_ai_tpu_torch import bench
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
from multimodal_active_ai_tpu_torch.train.optimizers import AdamMuDtype, get_optimizer

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"BENCH_DEVICE": "cpu", "BENCH_WINDOWS": "1"}
B, STEPS, F_SIMCLR = 4, 2, 2      # the CPU defaults of both benches
# mode → (extra knobs, bench.py function, units a window)
MODES = {
    "simclr": ({}, "main", STEPS * F_SIMCLR * B),
    "simclr_gram_adam_mu": ({"BENCH_STATS": "gram", "BENCH_ADAM_MU": "bfloat16"}, "main",
                            STEPS * F_SIMCLR * B),
    "host": ({"BENCH_INPUT": "host", "BENCH_SRC": "64"}, "main", STEPS * F_SIMCLR * B),
    "detr": ({"BENCH_MODE": "detr"}, "detr_inference_bench", STEPS * B),
    "probe": ({"BENCH_MODE": "probe"}, "probe_bench", STEPS * B),
    "rls": ({"BENCH_MODE": "rls"}, "rls_bench", STEPS * B),
    "captions": ({"BENCH_MODE": "captions"}, "captions_bench", STEPS * B),
}
PORT_ONLY = {"device", "launches"}


# ---------------------------------------------------------------------------
# bench.py, read with ast


def _functions() -> dict:
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _text(node, arch: str) -> str:
    """A string constant, or an f-string with ``arch.lower()`` in its one
    placeholder."""
    if isinstance(node, ast.Constant):
        return node.value
    return "".join(v.value if isinstance(v, ast.Constant) else arch.lower()
                   for v in node.values)


def _keys(node: ast.Dict) -> set:
    return {k.value for k in node.keys}


def jax_record(mode: str, arch: str = "ResNet18") -> tuple[str, set, set | None]:
    """``(metric, record keys, config keys or None)`` that ``bench.py``
    writes in ``mode`` at its defaults."""
    fns = _functions()
    _, fn, _ = MODES[mode]
    if fn == "main":
        parts = {id(v) for n in ast.walk(fns["main"]) if isinstance(n, ast.JoinedStr)
                 for v in n.values}
        metrics = [_text(n, arch) for n in ast.walk(fns["main"]) if id(n) not in parts
                   and (isinstance(n, ast.JoinedStr) or isinstance(n, ast.Constant)
                        and isinstance(n.value, str))
                   and "_per_sec_per_chip" in _text(n, arch)]
        want = "e2e_host" if mode == "host" else f"simclr_{arch.lower()}_aug_fwd_bwd"
        (metric,) = {m for m in metrics if want in m}
        record = [n for n in ast.walk(fns["main"]) if isinstance(n, ast.Dict)
                  and "metric" in _keys(n)][0]
        keys = _keys(record)
        if mode != "host":      # the windows, written unless input_mode == "host"
            keys |= {t.slice.value for n in ast.walk(fns["main"]) if isinstance(n, ast.If)
                     and "host" in ast.unparse(n.test) and "!=" in ast.unparse(n.test)
                     for s in n.body if isinstance(s, ast.Assign)
                     for t in s.targets if isinstance(t, ast.Subscript)}
        if mode == "simclr_gram_adam_mu":
            keys |= {"norm", "adam_mu_dtype"}
        return metric, keys, None
    if fn == "detr_inference_bench":
        record = [n for n in ast.walk(fns[fn]) if isinstance(n, ast.Dict)
                  and "metric" in _keys(n)][0]
        values = dict(zip((k.value for k in record.keys), record.values))
        return values["metric"].value, _keys(record), _keys(values["config"])
    emit = [n for n in ast.walk(fns[fn]) if isinstance(n, ast.Call)
            and getattr(n.func, "id", None) == "_emit"][0]
    record = [n for n in ast.walk(fns["_emit"]) if isinstance(n, ast.Dict)][0]
    return emit.args[0].value, _keys(record), _keys(emit.args[4])


# ---------------------------------------------------------------------------
# the port, in-process


def run_port(knobs: dict, capsys, monkeypatch) -> tuple[dict, list[str], str]:
    """``bench.main`` with the clock advancing 1 s a call; returns the
    record, the stdout lines and stderr."""
    clock = itertools.count()
    monkeypatch.setattr(bench, "perf_counter", lambda: float(next(clock)))
    record = bench.main({**CPU, **knobs})
    out, err = capsys.readouterr()
    return record, out.splitlines(), err


@pytest.mark.parametrize("mode", sorted(MODES))
def test_each_mode_prints_bench_py_record_at_its_units(mode, capsys, monkeypatch, tmp_path):
    knobs, _, units = MODES[mode]
    if mode == "host":
        knobs = {**knobs, "BENCH_CACHE": str(tmp_path / "cache")}
    record, lines, err = run_port(knobs, capsys, monkeypatch)
    assert len(lines) == 1 and json.loads(lines[0]) == record
    metric, keys, config = jax_record(mode)
    assert record["metric"] == metric
    assert set(record) == keys - {"vs_baseline"} | PORT_ONLY
    assert "vs_baseline" not in record and record["unit"] == "images/sec/chip"
    assert record["device"] == {"name": "cpu"}
    # one window of 1 s: the window's units, per chip
    assert record["value"] == units
    if mode != "host":
        assert record["windows_img_s_chip"] == [units] and record["median_img_s_chip"] == units
    else:
        assert "loader (" in err and "0 decoded, 12 cache hits" in err
    if config is None:
        assert "config" not in record
    else:
        assert set(record["config"]) == config
        assert record["config"]["batch"] == B and record["config"]["canvas"] == 64
    if mode == "simclr_gram_adam_mu":
        assert record["norm"] == {"kind": "bn", "stat_fusion": "gram"}
        assert record["adam_mu_dtype"] == "bfloat16"
    # the CPU runs the kernels' plain versions: no launch is counted
    assert record["launches"] == dict.fromkeys(bench.KERNELS, 0)


def test_without_cuda_the_bench_raises_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the bench runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main({"BENCH_MODE": "detr"})


def test_the_mfu_line_counts_a_step_and_says_not_measured_on_the_cpu(capsys, monkeypatch):
    counts = []
    for _ in range(2):
        _, _, err = run_port({"BENCH_MFU": "1"}, capsys, monkeypatch)
        (line,) = [x for x in err.splitlines() if x.startswith("# MFU:")]
        assert "GFLOP/step" in line and "MFU not measured on the CPU" in line
        counts.append(int(re.search(r"\((\d+) FLOP", line).group(1)))
    assert counts[0] == counts[1]
    # the step's 1 + F forwards alone; backward passes add about 2x each of the F
    model = SimCLRModule("ResNet18", dtype=torch.bfloat16, generator=torch.Generator())
    glimpses = torch.rand(B, 30, 30, 12)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        for _ in range(1 + F_SIMCLR):
            model(glimpses)
    assert 2 * fc.get_total_flops() < counts[0] < 3 * fc.get_total_flops()


def test_mfu_with_the_pallas_statistics_is_refused():
    with pytest.raises(ValueError, match="FlopCounterMode cannot count"):
        bench.main({**CPU, "BENCH_MFU": "1", "BENCH_STATS": "pallas"})


def test_pallas_statistics_on_several_ranks_are_refused(monkeypatch):
    import multimodal_active_ai_tpu_torch.models.norm as norm

    monkeypatch.setattr(norm, "world_size", lambda: 2)
    with pytest.raises(SystemExit, match="BENCH_STATS=pallas is single-device only"):
        bench.main({**CPU, "BENCH_STATS": "pallas"})


def test_jax_only_knobs_are_ignored_aloud_and_bad_knobs_raise(capsys):
    with pytest.raises(ValueError, match="BENCH_MODE=bogus"):
        bench.main({**CPU, "BENCH_MODE": "bogus", "BENCH_UNROLL": "5", "BENCH_NO_DONATE": "1",
                    "BENCH_FORCE_MESH": "1"})
    err = capsys.readouterr().err
    for key in bench.JAX_ONLY:
        assert f"# {key} ignored:" in err
    with pytest.raises(ValueError, match="BENCH_WINDOWS must be >= 1"):
        bench.main({**CPU, "BENCH_WINDOWS": "0"})


def test_two_ranks_print_one_record_at_a_per_chip_rate(tmp_path):
    """SimCLR as a 2-process gloo job, each rank 4 rows of a global batch
    of 8: rank 0 alone prints, and a 1 s window of 2·F·8 views is
    2·F·4 a chip."""
    code = ("import itertools; from multimodal_active_ai_tpu_torch import bench; "
            "c = itertools.count(); bench.perf_counter = lambda: float(next(c)); bench.main()")
    env = {**os.environ, **CPU, "MAAI_NUM_PROCESSES": "2", "OMP_NUM_THREADS": "1",
           "MAAI_COORDINATOR": f"file://{tmp_path / 'rendezvous'}",
           "PYTHONPATH": os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, "-c", code], env={**env, "MAAI_PROCESS_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
    records = [[json.loads(x) for x in out.splitlines() if x.startswith("{")] for out, _ in outs]
    assert len(records[0]) == 1 and records[1] == []
    assert "distributed: 2 ranks, backend gloo" in outs[0][0]
    assert records[0][0]["value"] == STEPS * F_SIMCLR * B
    assert records[0][0]["windows_img_s_chip"] == [STEPS * F_SIMCLR * B]


# ---------------------------------------------------------------------------
# Adam's mu_dtype


def test_adam_mu_dtype_matches_optax_over_five_updates():
    """``get_optimizer('adam', mu_dtype=bf16)`` against ``optax.adam(lr,
    mu_dtype=bf16)``, 5 updates on the same gradients (four decades of
    scale). Both round ``β1·mu`` and the stored ``mu`` to bf16 at the same
    places, so the stored moments agree to one bf16 unit (relative 2^-8)
    and the parameters to float32 rounding of the update arithmetic
    (1e-6 absolute on parameters of size ~4, i.e. a few float32 units)."""
    rng = np.random.RandomState(0)
    shapes = [(64, 32), (32,), (3, 3, 8, 16)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(rng.randn(*s) * 10 ** rng.uniform(-3, 1)).astype(np.float32) for s in shapes]
             for _ in range(5)]
    lr = 1e-3
    tx = optax.adam(lr, mu_dtype=jnp.bfloat16)
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = get_optimizer("adam", tp, mu_dtype=torch.bfloat16)
    assert isinstance(opt, AdamMuDtype)
    opt.param_groups[0]["lr"] = lr
    for g in grads:
        u, st = tx.update([jnp.asarray(x) for x in g], st, jp)
        jp = optax.apply_updates(jp, u)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.step()
    for j, t, mu in zip(jp, tp, st[0].mu):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=1e-6)
        m = opt.state[t]["exp_avg"]
        assert m.dtype == torch.bfloat16 and mu.dtype == jnp.bfloat16
        np.testing.assert_allclose(m.float().numpy(), np.asarray(mu.astype(jnp.float32)),
                                   rtol=2 ** -8, atol=0)
    assert get_optimizer("adam", tp).__class__ is torch.optim.Adam
    with pytest.raises(ValueError, match="mu_dtype is an option of adam"):
        get_optimizer("sgd", tp, mu_dtype=torch.bfloat16)


# ---------------------------------------------------------------------------
# bench.py itself (slow: XLA compiles each mode's step on the CPU)


@pytest.mark.slow
@pytest.mark.parametrize("mode", sorted(MODES))
def test_bench_py_and_the_port_write_one_record(mode, capsys, monkeypatch, tmp_path):
    knobs, _, _ = MODES[mode]
    env = {k: v for k, v in os.environ.items() if not k.startswith(("BENCH_", "XLA_FLAGS"))}
    env.update(JAX_PLATFORMS="cpu", BENCH_WINDOWS="1", **knobs)
    out = subprocess.run([sys.executable, "bench.py"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    jax_rec = json.loads([x for x in out.stdout.splitlines() if x.startswith("{")][-1])
    port, _, _ = run_port(knobs, capsys, monkeypatch)
    assert set(jax_rec) - {"vs_baseline"} == set(port) - PORT_ONLY
    for key in set(jax_rec) - {"vs_baseline", "value", "windows_img_s_chip",
                               "median_img_s_chip"}:
        assert port[key] == jax_rec[key], key
    assert len(port.get("windows_img_s_chip", [])) == len(jax_rec.get("windows_img_s_chip", []))
