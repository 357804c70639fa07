"""The port's spans, the collectives' counters and the readers of the spans.

``utils/profiling.span`` is a shared no-op context without a profiler and a
``record_function`` under one; the SimCLR and DETR train steps (ResNet18,
b = 4, canvas 64, on the CPU) give the documented tree of spans, the same
losses and weights with the profiler on and off, and names that fall in no
kernel group of ``benchmark/trace.py``. The ``HostLoader``'s consumer wait
is an ``input.wait`` span; the collectives count their calls and bytes on
2 gloo ranks; ``span_table`` and ``span_layers`` read a profile; and
the benchmark's four readers of the spans give their known answers on a
trace built by hand, and None on a trace without spans.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_active_ai_tpu_torch.data.loader import HostLoader
from multimodal_active_ai_tpu_torch.models.detr import DETR
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
from multimodal_active_ai_tpu_torch.objectives.set_criterion import SetCriterion
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.train import detr_train, optimizers, simclr_train
from multimodal_active_ai_tpu_torch.utils import profiling
from torch_port_distributed_cases import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import spec  # noqa: E402
from benchmark import trace as btrace  # noqa: E402
from benchmark.trace import Span, Trace  # noqa: E402

torch.set_num_threads(1)
CFG = retina.RetinaConfig(canvas_size=64, glimpse_size=30, crop_sizes=(40, 24, 10, 30))
B, F = 4, 2
CPU = [torch.profiler.ProfilerActivity.CPU]

# every span the program opens (``utils/profiling.span``)
SPANS = ["trainers.step", "trainers.eval_step", "trainers.loss", "trainers.backward",
         "trainers.update", "trainers.clip", "trainers.metrics", "retina.pyramid",
         "retina.sample", "retina.draw", "models.encoder", "models.encoder.stem",
         "models.encoder.layer1", "models.encoder.layer2", "models.encoder.layer3",
         "models.encoder.layer4", "models.projector", "models.embed", "models.transformer",
         "models.transformer.encoder", "models.transformer.decoder", "models.head",
         "collectives.gather", "collectives.sum", "collectives.grad_mean", "input.wait"]


def _images(seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (B, 64, 64, 3), dtype=torch.uint8, generator=g)


def _simclr():
    model = SimCLRModule(arch="ResNet18", generator=torch.Generator().manual_seed(1))
    state = simclr_train.TrainState(model, optimizers.get_optimizer("adam", model.parameters()),
                                    lambda _: 1e-3, step=7)
    step = simclr_train.make_train_step(CFG, F, 0.5)
    images = _images()
    return state, lambda: step(state, images, torch.Generator().manual_seed(3))


def _detr():
    model = DETR("ResNet18", num_classes=10, num_queries=5, hidden_dim=32, nheads=2,
                 enc_layers=1, dec_layers=1, dim_feedforward=64, dropout=0.1,
                 generator=torch.Generator().manual_seed(1))
    state = simclr_train.TrainState(model, detr_train.make_detr_optimizer(model, 1e-3, 1e-4, 1e-4),
                                    detr_train.step_lr(10, 100), step=7)
    step = detr_train.make_detr_train_step(SetCriterion(5, 10), CFG, F, 0.1)
    images, labels = _images(), torch.arange(B) % 10

    def run():
        return step(state, images, labels, torch.Generator().manual_seed(3),
                    dropout_generator=torch.Generator().manual_seed(4))["loss_ce"]

    return state, run


STEPS = {"simclr": _simclr, "detr": _detr}


def _tree(prof):
    """``[(name, [ancestor span names, innermost first])]`` of the user
    annotations' host ranges, in start order."""
    out = []
    for e in prof.events():
        if not e.is_user_annotation:
            continue
        up, p = [], e.cpu_parent
        while p is not None:
            if p.is_user_annotation:
                up.append(p.name)
            p = p.cpu_parent
        out.append((e.name, up))
    return out


# ---------------------------------------------------------------------------
# the helper and the steps


def test_span_is_a_shared_null_context_without_a_profiler():
    assert profiling.span("trainers.step", 3) is profiling.span("retina.sample")
    with profiling.span("trainers.loss") as inside:
        assert inside is None
    with torch.profiler.profile(activities=CPU) as prof:
        with profiling.span("trainers.step", 3):
            pass
    assert [e.name for e in prof.events() if e.is_user_annotation] == ["trainers.step"]


@pytest.mark.parametrize("path", sorted(STEPS))
def test_steps_open_no_record_function_without_a_profiler(path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _, run = STEPS[path]()
    assert torch.isfinite(run()).all()


@pytest.mark.parametrize("path", sorted(STEPS))
def test_a_step_gives_the_tree_of_spans(path, monkeypatch):
    """One root with the update count as its argument; on SimCLR 1 + F
    retina samples and F losses, backwards and updates, on DETR one of
    each and the clip inside the update; ``Optimizer.step#*`` inside
    ``trainers.update``; every other range inside the root."""
    real, args = torch.profiler.record_function, []

    def recording(name, arg=None):
        args.append((name, arg))
        return real(name, arg)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    state, run = STEPS[path]()
    with torch.profiler.profile(activities=CPU) as prof:
        run()
    tree = _tree(prof)
    names = [n for n, _ in tree]
    updates = F if path == "simclr" else 1
    assert names.count("trainers.step") == 1 and ("trainers.step", "7") in args
    assert names.count("retina.sample") == (1 + F if path == "simclr" else 1)
    assert names.count("retina.pyramid") == 1
    for name in ("trainers.loss", "trainers.backward", "trainers.update"):
        assert names.count(name) == updates, name
    assert names.count("trainers.metrics") == 1
    assert names.count("models.encoder") == (1 + F if path == "simclr" else 1)
    for name, up in tree:
        if name != "trainers.step":
            assert up[-1] == "trainers.step", (name, up)
        if name.startswith("Optimizer.step#"):
            assert up[0] == "trainers.update"
    clips = [up for n, up in tree if n == "trainers.clip"]
    assert clips == ([["trainers.update", "trainers.step"]] if path == "detr" else [])
    assert state.step == 7 + updates
    assert set(names) - {n for n in names if n.startswith("Optimizer.")} <= set(SPANS)


@pytest.mark.parametrize("path", sorted(STEPS))
def test_losses_and_weights_are_the_same_with_the_profiler_on(path):
    state_off, run_off = STEPS[path]()
    state_on, run_on = STEPS[path]()
    off = run_off()
    with torch.profiler.profile(activities=CPU):
        on = run_on()
    assert torch.equal(off, on)
    for a, b in zip(state_off.model.parameters(), state_on.model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", SPANS)
def test_span_names_fall_in_no_kernel_group(name):
    """The breakdown names an idle gap by the innermost host range open in
    it, grouped by ``GROUPS`` fragments: a span named like a kernel group
    would be filed under that group."""
    assert btrace.group_of(name) == "other"


def test_input_wait_spans_the_consumers_wait(tmp_path):
    rng = np.random.RandomState(0)
    files = []
    for i in range(6):
        path = str(tmp_path / f"img_{i}.jpg")
        Image.fromarray(rng.randint(0, 256, (24, 24, 3), np.uint8)).save(path, quality=90)
        files.append(path)
    loader = HostLoader(files, None, batch_size=2, canvas_size=16, use_native=False,
                        prefetch=1, num_threads=1)
    with torch.profiler.profile(activities=CPU) as prof:
        batches = list(loader)
    waits = [n for n, _ in _tree(prof) if n == "input.wait"]
    # one wait a batch, and one for the end of the epoch
    assert len(batches) == 3 and len(waits) == 4 and loader.stats["batches"] == 3


# ---------------------------------------------------------------------------
# the collectives' counters


def test_collective_counters_and_spans_on_two_ranks(tmp_path):
    """One SimCLR step (ResNet10, ``sync_bn``, F = 2) a rank: 4 all-gathers
    of a (4, 128) float32 block (NT-Xent's two views, twice); 61 all-reduces
    of values: each of the 12 BatchNorms' ``(Σx, Σx², n)`` in 3 forwards
    and 2 backwards, and the metrics; 2 gradient all-reduces; each a span."""
    channels = [64] + [64] * 2 + [128] * 3 + [256] * 3 + [512] * 3
    bn_bytes = sum(2 * c + 1 for c in channels) * 4
    for out in run_ranks("spans", tmp_path):
        c = out["counts"]
        assert c["collectives.gather"] == (4, 4 * B * 128 * 4)
        assert c["collectives.sum"] == (36 + 24 + 1, 5 * bn_bytes + F * 4)
        assert c["collectives.grad_mean"] == (2, 2 * out["params"] * 4)
        for name, (calls, _) in c.items():
            assert out["spans"][name] == calls
        # the drivers' -v line: calls and MB a step, here over 2 steps
        assert out["line"].startswith("collectives a step (2 steps): gather 2.0 calls 0.00 MB"
                                      " | sum 30.5 calls ")


# ---------------------------------------------------------------------------
# span_table and span_layers


def test_span_table_of_a_cpu_step():
    """On the CPU: host lengths only, and the self lengths of one thread's
    spans add up to the root's length."""
    _, run = _simclr()
    with profiling.trace() as prof:
        run()
    rows = {r.name: r for r in profiling.span_table(prof)}
    assert rows["trainers.step"].count == 1 and rows["trainers.loss"].count == F
    assert rows["retina.sample"].count == 1 + F
    assert sum(r.host_self_ms for r in rows.values()) == pytest.approx(
        rows["trainers.step"].host_ms, rel=1e-9)
    assert all(0 <= r.host_self_ms <= r.host_ms for r in rows.values())
    assert all(r.device_ms == 0 and r.idle_ms == 0 for r in rows.values())
    assert profiling.span_layers(rows.values())["retina"] == 0


# A hand-built two-step trace (µs): step 1 with nested model ranges and a
# backward launched with no span open, step 2 with kernels in the
# ``trainers.backward`` range and after it; the benchmark's draws between.
HOST = [("trainers.step", 0, 100), ("trainers.loss", 50, 56), ("trainers.step", 121, 200)]
NOTES = [("trainers.step", 5, 8), ("retina.pyramid", 10, 14), ("retina.sample", 14, 20),
         ("models.encoder", 20, 50), ("models.encoder.layer1", 22, 30),
         ("trainers.loss", 50, 55), ("trainers.update", 71, 73),
         ("Optimizer.step#Adam.step", 73, 80), ("retina.sample", 125, 130),
         ("models.projector", 130, 140), ("trainers.loss", 140, 145),
         ("trainers.backward", 146, 150), ("Optimizer.step#Adam.step", 161, 170)]
KERNELS = [("mask", 5, 8), ("pyramid", 10, 14), ("sample", 14, 20), ("enc", 20, 22),
           ("layer1", 22, 30), ("enc", 30, 50), ("loss", 50, 55), ("bw", 56, 60),
           ("bw", 61, 70), ("clip", 71, 73), ("adam", 73, 80), ("draws", 110, 115),
           ("sample", 125, 130), ("proj", 130, 140), ("loss", 140, 145), ("bw", 146, 150),
           ("bw", 151, 160), ("adam", 161, 170), ("Memset (Device)", 170, 171)]


def test_span_rows_of_a_hand_built_trace():
    rows = {r.name: r for r in profiling.span_rows(
        [(n, a, b, 1) for n, a, b in HOST], NOTES, KERNELS)}
    device = {n: r.device_ms * 1e3 for n, r in rows.items() if r.device_ms}
    assert device == {"trainers.step": 3, "retina.pyramid": 4, "retina.sample": 11,
                      "models.encoder": 22, "models.encoder.layer1": 8,
                      "models.projector": 10, "trainers.loss": 10, "trainers.backward": 26,
                      "trainers.update": 2, "Optimizer.step#Adam.step": 16,
                      profiling.NO_SPAN: 5}
    idle = {n: r.idle_ms * 1e3 for n, r in rows.items() if r.idle_ms}
    assert idle == {"trainers.step": 2 + 1 + 1 + 30 + 1 + 1 + 1, "trainers.loss": 1,
                    profiling.NO_SPAN: 10}
    assert rows["trainers.step"].host_self_ms * 1e3 == 100 - 6 + 79
    layers = profiling.span_layers(rows.values())
    assert {k: round(v * 1e3) for k, v in layers.items()} == {
        "retina": 15, "models": 40, "loss": 10, "backward": 26, "update": 18,
        "outside the program": 5, "rest of the step": 3}


# ---------------------------------------------------------------------------
# the benchmark's readers of the spans


def _run(notes=True):
    device = [Span(*k) for k in KERNELS]
    annotations = [Span(*n) for n in NOTES] if notes else []
    host = sorted((Span(*h) for h in HOST if notes), key=lambda s: s.start)
    return SimpleNamespace(trace=Trace(device, annotations, host, 200.0), trace_steps=2)


@pytest.mark.parametrize("metric, want", [
    ("retina.device_ms", (4 + 6 + 5) / 2e3),
    ("models.forward_device_ms", (2 + 8 + 20 + 10) / 2e3),     # nested ranges merged
    ("trainers.backward_device_ms", (4 + 9 + 4 + 9) / 2e3),    # both rules
    ("dispatch.idle_outside_program_pct", 100 * 10 / 48),
])
def test_span_readers_on_a_hand_built_trace(metric, want):
    assert spec.reader(metric)(_run()) == pytest.approx(want, rel=1e-12)
    assert spec.reader(metric)(_run(notes=False)) is None
    assert spec.reader(metric)(SimpleNamespace(trace=None, trace_steps=2)) is None


def test_the_nested_ranges_trap():
    """``trace.time_under`` takes the last range that starts before a
    kernel, so a parent range's kernels after a child range go uncounted;
    the reader merges the ranges first."""
    assert btrace.time_under(_run().trace, "models.") < 40
