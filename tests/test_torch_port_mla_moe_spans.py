"""The generative caption step's spans and the MoE layer's counters, and
the benchmark's three readers of them.

One step of ``train/caption_lm`` (ResNet10 encoder, canvas 64, b = 3, F =
2, a 3-layer language model: one dense layer, two MoE layers holding 8 of
16 experts) under the CPU profiler gives the documented tree: the
projector and the language model inside the step's root, MLA once a
layer, the MoE's four stages once an MoE layer, the head once, all inside
``models.lm``; the names fall in no kernel group of ``benchmark/trace.py``.
The counters equal the routing's own counts. The readers give their known
answers on a trace built by hand and None on a trace without the spans.
"""

import os
import sys
from types import SimpleNamespace

import pytest
import torch

from multimodal_active_ai_tpu_torch.models import moe
from multimodal_active_ai_tpu_torch.models.glimpse_vlm import GlimpseVLM, init_weights_
from multimodal_active_ai_tpu_torch.models.moe_lm import MoELMConfig
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.train import caption_lm
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import spec  # noqa: E402
from benchmark import trace as btrace  # noqa: E402
from benchmark.trace import Span, Trace  # noqa: E402

torch.set_num_threads(1)
CFG = retina.RetinaConfig(canvas_size=64, glimpse_size=30, crop_sizes=(40, 24, 10, 30))
LM = dict(vocab_size=50, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
          num_hidden_layers=3, num_attention_heads=4, n_shared_experts=2, n_routed_experts=16,
          kv_lora_rank=32, qk_rope_head_dim=16, v_head_dim=24, qk_nope_head_dim=24,
          held=(0, 8))
B, F, LT = 3, 2, 7
SPANS = ["models.vlm_projector", "models.lm", "models.lm.attention", "models.lm.moe.route",
         "models.lm.moe.experts", "models.lm.moe.shared", "models.lm.moe.combine",
         "models.lm.head"]


def _step():
    g = torch.Generator().manual_seed(4)
    model = init_weights_(GlimpseVLM(MoELMConfig.from_dict(LM), channels=512), g)
    state = TrainState(model, caption_lm.make_caption_lm_optimizer(model, 0.1),
                       lambda _: 1e-3, step=5)
    encoder = SimCLRModule(arch="ResNet10", generator=torch.Generator().manual_seed(1))
    images = torch.randint(0, 256, (B, 64, 64, 3), dtype=torch.uint8, generator=g)
    tokens = torch.randint(1, 50, (B, LT), generator=g)
    tokens[1, 3:] = 0
    fix = torch.rand(F * B, 2, generator=g)
    step = caption_lm.make_caption_lm_train_step(CFG, F, 0)
    return state, lambda: step(state, encoder, images, tokens, fix_yx=fix)


def _tree(prof):
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


def test_a_caption_step_gives_the_tree_of_spans():
    state, run = _step()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = run()
    assert torch.isfinite(out["loss"]) and state.step == 6
    tree = _tree(prof)
    names = [n for n, _ in tree]
    want = {"models.vlm_projector": 1, "models.lm": 1, "models.lm.attention": 3,
            "models.lm.head": 1, "trainers.step": 1, "trainers.loss": 1,
            "trainers.backward": 1, "trainers.update": 1, "trainers.clip": 1}
    for stage in ("route", "experts", "shared", "combine"):
        want[f"models.lm.moe.{stage}"] = 2
    for name, n in want.items():
        assert names.count(name) == n, name
    for name, up in tree:
        if name.startswith("models.lm."):
            assert "models.lm" in up and up[-1] == "trainers.step", (name, up)
        if name == "models.vlm_projector":
            assert up == ["trainers.step"]


@pytest.mark.parametrize("name", SPANS)
def test_span_names_fall_in_no_kernel_group(name):
    low = name.lower()
    assert not any(frag in low for frag, _ in btrace.GROUPS), name


def test_counters_equal_the_routing():
    layer = moe.MoE(64, 16, 6, 32, 2, 2.446, range(4, 12))
    with torch.no_grad():
        for t in layer.parameters():
            t.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(2))
    layer.grouped = False
    moe.reset_counts()
    loads = []
    for seed in (1, 2):
        x = torch.randn(2, 13, 64, generator=torch.Generator().manual_seed(seed))
        _, r = layer(x)
        loads.append(r.load)
        chosen = r.chosen.flatten()
        assert torch.equal(r.load, torch.bincount(chosen, minlength=16))
    held = [ld[4:12] for ld in loads]
    assert moe.counts() == {"calls": 2, "rows": int(sum(h.sum() for h in held)),
                            "max_expert_rows": int(max(h.max() for h in held)),
                            "held": 8, "hidden": 64, "width": 32}
    moe.reset_counts()
    assert moe.counts()["calls"] == 0


def _run(tr, steps=2):
    return SimpleNamespace(trace=tr, trace_steps=steps,
                           peaks={"bf16_flops": 1e12, "hbm_bytes_per_s": 1e9})


def _kernel(name, start, end):
    return Span(name, float(start), float(end))


def test_the_readers_on_a_hand_built_trace(monkeypatch):
    """Two steps: attention kernels 10 µs and 20 µs, MoE stages 5 + 7 µs
    with 40 µs in ``models.lm.moe.experts`` over 2 calls, a kernel outside
    every range."""
    ann = [Span("models.lm.attention", 0, 30), Span("models.lm.moe.route", 30, 40),
           Span("models.lm.moe.experts", 40, 60), Span("models.lm.moe.shared", 60, 70),
           Span("models.lm.attention", 100, 130), Span("models.lm.moe.experts", 130, 160)]
    kernels = [_kernel("a", 1, 11), _kernel("b", 101, 121), _kernel("r", 31, 36),
               _kernel("e", 41, 61), _kernel("s", 61, 68), _kernel("e2", 131, 151),
               _kernel("x", 200, 210)]
    tr = Trace(kernels, ann, [], 300.0)
    assert spec.reader("mla.forward_device_ms")(_run(tr)) == pytest.approx(30 / 1e3 / 2)
    assert spec.reader("moe.forward_device_ms")(_run(tr)) == pytest.approx(52 / 1e3 / 2)
    monkeypatch.setattr(moe, "_COUNTS", {"calls": 4, "rows": 400, "max_expert_rows": 30,
                                         "held": 8, "hidden": 64, "width": 32})
    ops = 2.0 * 100 * 3 * 64 * 32
    nbytes = 8 * 3 * 64 * 32 * 4 + 100 * 64 * 2 * 2
    least_us = max(ops / 1e12, nbytes / 1e9) * 1e6
    assert spec.reader("moe.experts_roofline_pct")(_run(tr)) == pytest.approx(
        100 * 2 * least_us / 40)
    empty = Trace(kernels, [], [], 300.0)
    for name in ("mla.forward_device_ms", "moe.forward_device_ms", "moe.experts_roofline_pct"):
        assert spec.reader(name)(_run(empty)) is None
    moe.reset_counts()
    assert spec.reader("moe.experts_roofline_pct")(_run(tr)) is None
