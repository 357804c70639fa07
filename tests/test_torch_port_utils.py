"""The port's last utilities: plotting, profiling, the async checkpointer,
``--unroll-fixations``, the naive NT-Xent oracle, the glimpse helpers,
``select_action`` and the four example twins, on the CPU."""

import builtins
import importlib.util
import os
import re
import shutil
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_active_ai_tpu.objectives.ntxent import naive_ntxent_loss as jnaive
from multimodal_active_ai_tpu_torch import contrastive_learning as driver
from multimodal_active_ai_tpu_torch.models.qnet import build_dqn
from multimodal_active_ai_tpu_torch.objectives.ntxent import naive_ntxent_loss
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.rl import policy
from multimodal_active_ai_tpu_torch.utils import checkpoint as tckpt
from multimodal_active_ai_tpu_torch.utils import plotting, profiling

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PNG = b"\x89PNG\r\n\x1a\n"


# ---------------------------------------------------------------------------
# plotting


def test_plot_training_stats_writes_a_png(tmp_path):
    out = plotting.plot_training_stats([3.0, 2.5, 2.0], [0.1, 0.2, 0.4], [0.5, 0.6, 0.8],
                                       out_path=str(tmp_path / "h.png"))
    assert out == str(tmp_path / "h.png")
    with open(out, "rb") as f:
        assert f.read(8) == PNG


def test_plot_training_stats_without_matplotlib(tmp_path, monkeypatch):
    real = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.startswith("matplotlib"):
            raise ImportError("no matplotlib here")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    assert plotting.plot_training_stats([1.0], [0.0], [0.0],
                                        out_path=str(tmp_path / "h.png")) is None
    assert not os.path.exists(tmp_path / "h.png")


# ---------------------------------------------------------------------------
# profiling


def test_profiling_on_the_cpu(tmp_path):
    """A CPU trace has no device work: ``device_leaf_ops`` gives ``[]``;
    ``trace`` writes its Chrome trace; ``StepTimer`` times CPU tensors;
    ``device_memory_stats`` is empty without CUDA."""
    with profiling.trace(str(tmp_path / "tr")) as prof:
        y = torch.ones(64, 64) @ torch.ones(64, 64)
    assert profiling.device_leaf_ops(prof) == []
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    with profiling.trace(enabled=False) as off:
        assert off is None
    timer = profiling.StepTimer()
    for _ in range(2):
        timer.start()
        timer.stop(y + 1)
    assert len(timer.times) == 2 and timer.avg >= 0
    assert re.match(r"steps=2 avg=\S+ms throughput=\S+/s", timer.summary(8))
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}


# ---------------------------------------------------------------------------
# the async checkpointer


def test_async_checkpointer_lands_saves_in_order(tmp_path, monkeypatch):
    """A second ``save`` waits for the first: never two writes at once, the
    files written in call order, the last payload on disk after ``wait``."""
    active, order, peak = [], [], [0]
    real = tckpt.save_checkpoint

    def slow(payload, is_best, filename, best_filename):
        active.append(1)
        peak[0] = max(peak[0], len(active))
        time.sleep(0.05)
        order.append(int(payload["epoch"]))
        real(payload, is_best, filename, best_filename)
        active.pop()

    monkeypatch.setattr(tckpt, "save_checkpoint", slow)
    saver = tckpt.AsyncCheckpointer()
    path = str(tmp_path / "ck.pth.tar")
    for epoch in range(1, 4):
        saver.save({"epoch": epoch, "w": torch.full((3,), float(epoch))}, epoch == 2, path,
                   str(tmp_path / "best.pth.tar"))
    saver.wait()
    assert order == [1, 2, 3] and peak[0] == 1
    assert tckpt.load_checkpoint(path)["epoch"] == 3
    assert tckpt.load_checkpoint(str(tmp_path / "best.pth.tar"))["epoch"] == 2
    assert not [t for t in threading.enumerate() if t.name == "checkpoint-save"]


def test_async_checkpointer_reraises_a_failed_save(tmp_path):
    (tmp_path / "file").write_text("x")
    saver = tckpt.AsyncCheckpointer()
    saver.save({"epoch": 1}, False, str(tmp_path / "file" / "ck.pth.tar"))
    with pytest.raises(RuntimeError, match="async checkpoint save failed") as err:
        saver.wait()
    assert isinstance(err.value.__cause__, OSError)
    saver.wait()            # the error is raised once


def test_async_checkpointer_keeps_the_weights_of_the_save_not_of_the_next_step(tmp_path):
    """Save, take an Adam step that updates the weights and moments in
    place, then ``wait``: the file holds the snapshot of the save."""
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    x = torch.randn(8, 4, generator=torch.Generator().manual_seed(0))

    def step():
        opt.zero_grad()
        model(x).square().sum().backward()
        opt.step()

    step()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moments = {k: v.clone() for k, v in opt.state_dict()["state"][0].items()}
    saver = tckpt.AsyncCheckpointer()
    path = str(tmp_path / "ck.pth.tar")
    saver.save({"state_dict": model.state_dict(), "optimizer": opt.state_dict()}, False, path)
    step()
    saver.wait()
    saved = tckpt.load_checkpoint(path)
    assert all(torch.equal(saved["state_dict"][k], v) for k, v in before.items())
    assert all(torch.equal(saved["optimizer"]["state"][0][k], v) for k, v in moments.items())
    assert not torch.equal(saved["state_dict"]["weight"], model.weight.detach())


# ---------------------------------------------------------------------------
# the SimCLR driver: --unroll-fixations, the saver and -pth

ARGS = ["--dataset", "synthetic", "--arch", "ResNet10", "-b", "4", "--canvas-size", "64",
        "-f", "3", "-t", "--num-examples", "8", "-p", "1", "--no-bf16", "--device", "cpu",
        "--epochs", "1"]


def test_unroll_fixations_changes_nothing(tmp_path, capsys):
    """``--unroll-fixations`` 5 and -1 give the losses and weights of 0 bit
    for bit (it tunes only the JAX scan); then ``-pth`` on the checkpoint
    the async saver wrote draws the figure and prints the histories."""
    runs = {}
    for unroll in ("5", "-1", "0"):
        state = driver.main(ARGS + ["--unroll-fixations", unroll,
                                    "--checkpoint-dir", str(tmp_path / unroll)])
        runs[unroll] = (re.findall(r"Loss (\S+)", capsys.readouterr().out),
                        {k: v.clone() for k, v in state.model.state_dict().items()})
        if unroll != "0":
            shutil.rmtree(tmp_path / unroll)    # ~0.3 GB of checkpoints a run
    losses, weights = runs["0"]
    assert losses
    for unroll in ("5", "-1"):
        assert runs[unroll][0] == losses
        assert all(torch.equal(runs[unroll][1][k], v) for k, v in weights.items())

    ck = tmp_path / "0"
    payload = tckpt.load_checkpoint(str(ck / "checkpoint.pth.tar"))
    assert all(torch.equal(payload["state_dict"][k], v) for k, v in weights.items())
    driver.main(ARGS + ["--checkpoint-dir", str(ck), "--resume", str(ck / "checkpoint.pth.tar"),
                        "-pth"])
    out = capsys.readouterr().out
    assert f"training history figure written to {ck / 'training_history.png'}" in out
    assert "loss_history: [" in out and "top5_acc_history: [" in out
    with open(ck / "training_history.png", "rb") as f:
        assert f.read(8) == PNG


# ---------------------------------------------------------------------------
# the functions the example twins use


def test_naive_ntxent_matches_jax():
    rng = np.random.default_rng(1)
    z1, z2 = (rng.standard_normal((6, 16)).astype(np.float32) for _ in range(2))
    want = float(jnaive(jnp.asarray(z1), jnp.asarray(z2), 0.5))
    got = float(naive_ntxent_loss(torch.from_numpy(z1), torch.from_numpy(z2), 0.5))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_glimpse_helpers_are_the_retina_views():
    cfg = retina.RetinaConfig(canvas_size=64, crop_sizes=(40, 24, 10, 30))
    g = torch.Generator().manual_seed(2)
    images = torch.randint(0, 256, (3, 64, 64, 3), dtype=torch.uint8, generator=g)
    p = retina.sample_unlabeled_params(g, 3, 64, cfg)
    noise = torch.randn(retina.noise_shape(cfg, 3), generator=g)
    assert torch.equal(retina.unlabeled_glimpses(images, p, cfg, noise=noise),
                       retina.apply_retina(images, p, cfg, True, noise=noise))
    lp = retina.sample_labeled_params(g, 3, 64)
    assert torch.equal(retina.labeled_glimpses(images, lp, cfg),
                       retina.apply_retina(images, lp, cfg, False))


def test_select_action_draws_one_coin_for_the_batch():
    """The coin above ε: the greedy action of every row; at or below: the
    random fixations of ``generator``."""
    dqn = build_dqn("ResNet10", 10, generator=torch.Generator().manual_seed(3))
    states = torch.rand(4, 30, 30, 12, generator=torch.Generator().manual_seed(4)) * 255
    kw = dict(epoch=0, eps_start=0.5, eps_end=0.5, eps_decay=1.0, num_of_actions=10)
    seen = set()
    for seed in range(8):
        coin = float(torch.rand((), generator=torch.Generator().manual_seed(seed)))
        got = policy.select_action(dqn, states, torch.Generator().manual_seed(9),
                                   torch.Generator().manual_seed(seed), **kw)
        want = (policy.select_action_from_policy(dqn, states, 10) if coin > 0.5 else
                policy.select_random_action(torch.Generator().manual_seed(9), 4))
        assert torch.equal(got, want)
        seen.add(coin > 0.5)
    assert seen == {True, False}


# ---------------------------------------------------------------------------
# the example twins


def _example(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "examples",
                                                                     f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", ["torch_contrastive_learning_demo",
                                  "torch_reinforced_transformer_demo",
                                  "torch_retina_visualization"])
def test_example_twin_runs_on_the_cpu(name, tmp_path, capsys):
    argv = ["--device", "cpu"]
    if name == "torch_retina_visualization":
        argv += ["--out", str(tmp_path / "sheet.png")]
    out = _example(name).main(argv)
    printed = capsys.readouterr().out
    if name == "torch_contrastive_learning_demo":
        assert out["glimpses"].shape == (8, 30, 30, 12)
        assert torch.isfinite(out["losses"]).all() and "naive NT-Xent" in printed
    elif name == "torch_reinforced_transformer_demo":
        assert out["glimpses"].shape == (4, 3, 30, 30, 12) and out["ids"].shape == (4, 8)
        assert all(np.isfinite(out["losses"]))
    else:
        assert [tuple(c.shape) for c in out["crops"]] == [
            (640, 640, 3), (400, 400, 3), (240, 240, 3), (100, 100, 3), (30, 30, 3)]
        assert out["sheet"].shape == (120, 600, 3)
        with open(tmp_path / "sheet.png", "rb") as f:
            assert f.read(8) == PNG


def test_example_twins_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CUDA-less case")
    for name in ("torch_contrastive_learning_demo", "torch_resnet_tests"):
        with pytest.raises(RuntimeError, match="CUDA"):
            _example(name).main([])
