"""The port's MLA + MoE language model and its generative caption step
against the plain reference (``reference/mla_moe.py``), on seeded random
weights at a tiny size on the CPU, in float32 on both sides.

The size keeps every published ratio that shapes the code: a query and key
of ``nope + rope`` against a smaller value head, a latent of its own width,
one leading dense layer, 16 routed experts of which 8 are held, 6 a token,
2 shared, the published scaling factor and θ. Tolerances are relative to
the reference's largest magnitude (``_close``): 1e-5 where the two sides
sum the same float32 products in another order (measured below 1e-6), and
a looser one where a step of AdamW stands between them, each with its
reason where it is set.
"""

import json

import pytest
import torch

from multimodal_active_ai_tpu_torch import coco_captions_probe as driver
from multimodal_active_ai_tpu_torch.models import mla as tmla
from multimodal_active_ai_tpu_torch.models import moe as tmoe
from multimodal_active_ai_tpu_torch.models.glimpse_vlm import GlimpseVLM, init_weights_
from multimodal_active_ai_tpu_torch.models.moe_lm import MoELMConfig
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
from multimodal_active_ai_tpu_torch.ops import retina
from multimodal_active_ai_tpu_torch.reference import mla_moe as ref
from multimodal_active_ai_tpu_torch.train import caption_lm
from multimodal_active_ai_tpu_torch.train.eval_probe import frozen_feature_maps
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState

torch.set_num_threads(1)

C = dict(vocab_size=50, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
         num_hidden_layers=3, num_attention_heads=4, n_shared_experts=2, n_routed_experts=16,
         routed_scaling_factor=2.446, kv_lora_rank=32, qk_rope_head_dim=16, v_head_dim=24,
         qk_nope_head_dim=24, num_experts_per_tok=6, first_k_dense_replace=1,
         rms_norm_eps=1e-5, rope_theta=800000.0)
HELD = (0, 8)
RCFG = retina.RetinaConfig(canvas_size=64, glimpse_size=30, crop_sizes=(40, 24, 10, 30))
B, F, LT, PAD = 3, 2, 7, 0
STEP = dict(pad_id=PAD, balance_alpha=1e-4, bias_gamma=1e-3, clip_max_norm=1.0, lr=1e-3,
            weight_decay=0.1)


def _close(got, want, tol):
    got, want = got.detach().double(), want.detach().double()
    err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
    assert err <= tol, err


def _seeded(module, seed=1):
    """The reference's init plan drawn from one generator."""
    g = torch.Generator().manual_seed(seed)
    plan = []
    for m in module.modules():
        if hasattr(m, "init_plan"):
            plan += m.init_plan()
    with torch.no_grad():
        for t, std in plan:
            t.copy_(torch.randn(t.shape, generator=g) * std)
    return module


def _x(*shape, seed=2):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


# ---------------------------------------------------------------------------
# MLA


def test_mla_forward_and_gradients():
    """Output, input gradient and every weight's gradient under a random
    cotangent; the port's attention is torch's SDPA, the reference's two
    explicit products."""
    r = _seeded(ref.Attention(C))
    p = tmla.MLA(64, 4, 32, 24, 16, 24, 800000.0)
    p.load_state_dict(r.state_dict())
    x = _x(2, 9, 64).requires_grad_()
    xr = x.detach().clone().requires_grad_()
    out, want = p(x), r(xr, ref.EXACT)
    _close(out, want, 1e-5)
    cot = _x(*out.shape, seed=3)
    (out * cot).sum().backward()
    (want * cot).sum().backward()
    _close(x.grad, xr.grad, 1e-5)
    rp = dict(r.named_parameters())
    for n, t in p.named_parameters():
        _close(t.grad, rp[n].grad, 1e-5)


def test_rope_is_the_published_rotation():
    """Position 0 leaves a vector alone; the rotation keeps each regrouped
    pair's length; q·k after it depends on the positions' difference."""
    cos, sin = tmla.rope_tables(6, 16, 800000.0, "cpu", torch.float32)
    v = _x(1, 1, 6, 16)
    out = tmla.apply_rope(v, cos, sin)
    regrouped = v.unflatten(-1, (8, 2)).transpose(-1, -2).flatten(-2)
    _close(out[..., 0, :], regrouped[..., 0, :], 1e-7)
    pair = lambda t: t[..., :8] ** 2 + t[..., 8:] ** 2  # noqa: E731
    _close(pair(out), pair(regrouped), 1e-6)
    q, k = _x(16, seed=4).expand(1, 1, 6, 16), _x(16, seed=5).expand(1, 1, 6, 16)
    qr, kr = tmla.apply_rope(q, cos, sin), tmla.apply_rope(k, cos, sin)
    _close(qr[0, 0, 3] @ kr[0, 0, 1], qr[0, 0, 4] @ kr[0, 0, 2], 1e-5)


# ---------------------------------------------------------------------------
# the router and the MoE layer


def _router():
    r = _seeded(ref.Gate(64, 16, 6, 2.446))
    p = tmoe.Router(64, 16, 6, 2.446)
    p.load_state_dict(r.state_dict())
    return p, r


def _by_id(chosen, w):
    order = chosen.argsort(-1)
    return chosen.gather(-1, order), w.gather(-1, order)


def test_router_matches_the_reference():
    p, r = _router()
    x = _x(20, 64)
    pc, pw, ps = p(x)
    rc, rw, rs = r(x, ref.EXACT)
    pc, pw = _by_id(pc, pw)
    rc, rw = _by_id(rc, rw)
    assert torch.equal(pc, rc)
    _close(pw, rw, 1e-6)
    _close(ps, rs, 1e-6)


def test_router_bias_moves_the_choice_not_the_weights():
    """A bias of +1 on expert 5 puts it among every token's chosen; the
    weights are still the unbiased scores of the chosen, renormalised to 1
    and scaled by 2.446."""
    p, _ = _router()
    x = _x(20, 64)
    with torch.no_grad():
        p.e_score_correction_bias[5] = 1.0
    chosen, w, scores = p(x)
    assert bool((chosen == 5).any(-1).all())
    _close(w.sum(-1), torch.full((20,), 2.446), 1e-6)
    want = scores.gather(1, chosen)
    _close(w, want / want.sum(-1, keepdim=True) * 2.446, 1e-6)
    with torch.no_grad():
        p.e_score_correction_bias.zero_()
    assert not bool((p(x)[0] == 5).any(-1).all())


def _moe_pair(held=HELD, experts_of=None):
    r = _seeded(ref.MoE(C, range(*held)))
    p = tmoe.MoE(64, 16, 6, 32, 2, 2.446, range(*held))
    p.load_state_dict(r.state_dict())
    return p, r


@pytest.mark.parametrize("grouped", [False, True], ids=["loop", "grouped"])
def test_moe_layer_matches_the_reference(grouped):
    """The held experts' part, the shared experts, the routing's loads and
    every gradient (the router's through the weights); in float32 the loop
    over the held experts, in bf16 the grouped product against the loop
    (1e-2: bf16's rounding of the rows and the weights)."""
    p, r = _moe_pair()
    x = _x(2, 11, 64).requires_grad_()
    if not grouped:
        p.grouped = False
        out, routing = p(x)
        xr = x.detach().clone().requires_grad_()
        want, (scores, idx, load) = r(xr, ref.EXACT)
        _close(out, want, 1e-5)
        assert torch.equal(routing.load, load)
        cot = _x(*out.shape, seed=3)
        (out * cot).sum().backward()
        (want * cot).sum().backward()
        _close(x.grad, xr.grad, 1e-5)
        rp = dict(r.named_parameters())
        for n, t in p.named_parameters():
            _close(t.grad, rp[n].grad, 1e-5)
        return
    grads = []
    for p.grouped in (True, False):
        xb = x.detach().bfloat16().requires_grad_()
        p.zero_grad()
        with torch.autocast("cpu", dtype=torch.bfloat16):
            assert tmoe.grouped_available(xb)
            out, _ = p(xb)
        (out * _x(*out.shape, seed=3)).sum().backward()
        grads.append([out, xb.grad] + [t.grad.clone() for t in p.parameters()])
    for a, b in zip(*grads):
        _close(a, b, 1e-2)


def test_held_experts_keep_their_gate_and_up_rows_alone():
    """What the held experts keep for the backward that grows with their
    rows is ``h`` (gate and up, 2·width a row) beside the rows' indices and
    weights: the rows are gathered again and ``silu(g)·u`` recomputed, and
    no product is run twice."""
    p, _ = _moe_pair()
    x = _x(2, 13, 64).requires_grad_()
    kept = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: kept.append(t) or t, lambda t: t):
        out, routing = p(x)
    held = routing.load[HELD[0]:HELD[1]].tolist()
    rows = sum(-(-c // tmoe.ALIGN) * tmoe.ALIGN for c in held)
    assert rows not in (26, 64, 32)
    per_row = [t for t in kept if t.dim() and t.shape[0] == rows]
    assert sorted(tuple(t.shape) for t in per_row if t.is_floating_point()) == [
        (rows,), (rows, 2 * 32)]
    assert all(t.dtype == torch.long and t.dim() == 1 for t in per_row
               if not t.is_floating_point())


def test_the_shares_add_up_to_the_whole_layer():
    """16 experts over 8 ranks of 2: each rank's result less the shared
    experts, summed over the ranks, plus the shared experts once, is the
    uncut reference layer's result."""
    whole = _seeded(ref.MoE(C, range(16)))
    state = whole.state_dict()
    x = _x(2, 11, 64)
    shared = None
    total = torch.zeros_like(x)
    for rank in range(8):
        lo = 2 * rank
        part = tmoe.MoE(64, 16, 6, 32, 2, 2.446, range(lo, lo + 2))
        mine = {k: v for k, v in state.items() if not k.startswith("experts.")}
        mine["experts.gate_up_proj"] = state["experts.gate_up_proj"][lo:lo + 2]
        mine["experts.down_proj"] = state["experts.down_proj"][lo:lo + 2]
        part.load_state_dict(mine)
        part.grouped = False
        out, _ = part(x)
        if shared is None:
            shared = part.shared_experts(x.reshape(-1, 64)).reshape(x.shape)
        total = total + out - shared
    want, _ = whole(x, ref.EXACT)
    _close(total + shared, want, 1e-5)


def test_balance_loss_and_bias_rule_match_the_reference():
    p, r = _moe_pair()
    x = _x(2, 11, 64)
    _, routing = p(x)
    _, (scores, idx, load) = r(x, ref.EXACT)
    _close(tmoe.sequence_balance_loss(routing, 2), ref.balance_loss_sum(scores, idx, 2) / 2,
           1e-6)
    tmoe.update_bias(p.gate, routing.load, 1e-3)
    lf = load.float()
    _close(p.gate.e_score_correction_bias, 1e-3 * torch.sign(lf.mean() - lf), 1e-7)


def test_balanced_bias_evens_the_loads():
    """The seeding rule that the benchmark's caption cell and the card
    checks share: scores skewed from 5 to 454 rows an expert come out within
    3% of the even 180 each (measured 175-184)."""
    g = torch.Generator().manual_seed(0)
    scores = torch.sigmoid(torch.randn(480, 16, generator=g) + torch.linspace(-2, 2, 16))
    load = torch.bincount(torch.topk(scores + ref.balanced_bias(scores, 6), 6).indices.flatten(),
                          minlength=16)
    assert int(load.sum()) == 480 * 6
    assert int((load - 180).abs().max()) <= 6


# ---------------------------------------------------------------------------
# the whole VLM train step


def _encoder():
    enc = SimCLRModule(arch="ResNet10", generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.fill_(4.0)
    return enc


def _batch():
    g = torch.Generator().manual_seed(11)
    images = torch.randint(0, 256, (B, 64, 64, 3), dtype=torch.uint8, generator=g)
    tokens = torch.randint(1, 50, (B, LT), generator=g)
    tokens[0, 4:] = PAD
    tokens[2, 6:] = PAD
    fix = torch.rand(F * B, 2, generator=g)
    return images, tokens, fix


def _vlm_pair():
    c = dict(C, held=HELD, channels=512)
    r = _seeded(ref.GlimpseVLM(c))
    p = GlimpseVLM(MoELMConfig.from_dict(c), channels=512)
    p.load_state_dict(r.state_dict())
    return p, r


@pytest.fixture(scope="module")
def two_steps():
    """Two updates of the port's step and of the reference's on the same
    batch, their readings."""
    p, r = _vlm_pair()
    enc = _encoder()
    images, tokens, fix = _batch()
    opt = caption_lm.make_caption_lm_optimizer(p, STEP["weight_decay"])
    state = TrainState(p, opt, lambda _: STEP["lr"])
    step = caption_lm.make_caption_lm_train_step(RCFG, F, PAD, STEP["clip_max_norm"],
                                                 STEP["balance_alpha"], STEP["bias_gamma"])
    got = {"logits": [], "grads": {}, "bias": []}
    names = {id(t): n for n, t in p.named_parameters()}

    def first_grads(o, a, k):
        if not got["grads"]:
            got["grads"].update({names[id(t)]: t.grad.clone() for t in p.parameters()})

    hooks = [p.register_forward_hook(lambda m, a, o: got["logits"].append(o[0].detach())),
             opt.register_step_pre_hook(first_grads)]
    losses = []
    for _ in range(2):
        losses.append(step(state, enc, images, tokens, fix_yx=fix)["loss"])
        got["bias"].append([m.gate.e_score_correction_bias.clone()
                            for m in caption_lm.moe_layers(p)])
    for h in hooks:
        h.remove()
    maps = frozen_feature_maps(enc, images, RCFG, F, fix_yx=fix)
    ropt = ref.AdamW(dict(r.named_parameters()), STEP["weight_decay"])
    want = {"logits": [], "grads": {}, "bias": []}

    def maps_of(i, j):
        return maps.reshape(F, B, *maps.shape[1:])[:, i:j].reshape(-1, *maps.shape[1:])

    rlosses = []
    for s in range(2):
        rlosses.append(ref.train_step(
            r, ropt, maps_of, tokens, STEP, block=2, outputs=want["logits"] if s == 0 else None,
            on_first_update=None if s else lambda g: want["grads"].update(
                {n: t.clone() for n, t in g.items()})))
        want["bias"].append([layer.mlp.gate.e_score_correction_bias.clone()
                             for layer in r.lm.layers if isinstance(layer.mlp, ref.MoE)])
    return dict(p=p, r=r, got=got, want=want, losses=losses, rlosses=rlosses)


def test_step_logits_and_losses(two_steps):
    """The first step's logits (the reference's blocks of 2 sequences put
    back together) and both losses (measured 5e-7 and 6e-8)."""
    got, want = two_steps["got"], two_steps["want"]
    _close(got["logits"][0], torch.cat(want["logits"]), 1e-5)
    for a, b in zip(two_steps["losses"], two_steps["rlosses"]):
        _close(a, b, 1e-6)


def test_step_gradient_of_every_leaf(two_steps):
    """Each leaf's clipped gradient as AdamW gets it, the reference's
    accumulated over its blocks (measured 9e-7)."""
    got, want = two_steps["got"]["grads"], two_steps["want"]["grads"]
    assert set(got) == set(want)
    for n in want:
        _close(got[n], want[n], 1e-5)


def test_step_parameters_after_two_updates(two_steps):
    """AdamW's first updates are near ``lr·sign(g)`` a coordinate, so a
    coordinate whose gradient is rounding-sized on both sides may move by
    up to ``2·lr`` apart: the change of each leaf is held in norm, 3e-4
    of the reference's change (measured 3e-5)."""
    start = _vlm_pair()[1].state_dict()
    rp = dict(two_steps["r"].named_parameters())
    for n, t in two_steps["p"].named_parameters():
        got, want = t.detach() - start[n], rp[n].detach() - start[n]
        err = float((got - want).norm() / want.norm().clamp_min(1e-30))
        assert err <= 3e-4, (n, err)


def test_step_router_bias_after_each_update(two_steps):
    for got, want in zip(two_steps["got"]["bias"], two_steps["want"]["bias"]):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_init_weights_follow_the_reference_plan():
    c = dict(C, held=HELD, channels=512)
    p = init_weights_(GlimpseVLM(MoELMConfig.from_dict(c), channels=512),
                      torch.Generator().manual_seed(3))
    layer = p.lm.layers[1].mlp
    assert float(layer.gate.weight.detach().std()) == pytest.approx((3 * 64) ** -0.5, rel=0.1)
    assert float(layer.experts.gate_up_proj.detach().std()) == pytest.approx(ref.STD, rel=0.1)
    assert torch.equal(layer.gate.e_score_correction_bias, torch.zeros(16))
    assert torch.equal(p.lm.norm.weight, torch.ones(64))


# ---------------------------------------------------------------------------
# the driver


def test_driver_trains_the_generative_objective(tmp_path, capsys):
    """``coco_captions_probe.py --objective generative`` for two steps on
    synthetic data: finite losses, every parameter moved, the caption
    lines, a checkpoint that resumes."""
    lm = tmp_path / "lm.json"
    lm.write_text(json.dumps({k: v for k, v in C.items() if k != "vocab_size"}))
    args = ["--dataset", "synthetic", "-a", "ResNet10", "-b", "2", "-f", "2",
            "--canvas-size", "64", "-t", "--epochs", "1", "--device", "cpu", "--num-examples",
            "4", "--objective", "generative", "--lm-config", str(lm), "--vocab-size", "50",
            "--max-len", "8", "--lr", "1e-3",
            "--checkpoint-dir", str(tmp_path)]
    start = {n: t.clone() for n, t in driver.build_caption_lm(
        driver.parse_into(driver.CaptionLMConfig, args), 50,
        torch.device("cpu")).state_dict().items()}
    state, vocab = driver.main(args)
    out = capsys.readouterr().out
    assert vocab is None and state.step == 2
    assert "##Caption loss" in out and "##Next-token Top-1" in out
    for n, t in state.model.named_parameters():
        assert torch.isfinite(t).all() and not torch.equal(t, start[n]), n
    ckpt = tmp_path / "caption_lm_checkpoint.pth.tar"
    resumed, _ = driver.main(args + ["--resume", str(ckpt), "--epochs", "0"])
    for a, b in zip(resumed.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)
