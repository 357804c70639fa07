"""The Kimi-VL-A3B caption cell and the four-card SimCLR cell rehearsed
through ``run.py`` on the CPU at their files' ``rehearsal`` sizes: the
caption program ``correct``, the fp8 control and each fault that cell can
have not; SimCLR on four gloo ranks ``correct``, and not without its
gradient exchange; the new configuration's file beside the catalog's
published ``config.json`` keys."""

import json

import pytest

from benchmark import spec
from benchmark.tests.test_portbench_rehearsal import ROOT, check_line, run

CELL = "kimivl-a3b-cap-b16-f128"
X4 = "simclr-r50-b256-f10-x4"
PUBLISHED = {
    "vocab_size": 163840, "max_position_embeddings": 131072, "hidden_size": 2048,
    "intermediate_size": 11264, "moe_intermediate_size": 1408, "num_hidden_layers": 27,
    "num_attention_heads": 16, "n_shared_experts": 2, "n_routed_experts": 64, "ep_size": 1,
    "routed_scaling_factor": 2.446, "kv_lora_rank": 512, "q_lora_rank": None,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "qk_nope_head_dim": 128,
    "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1, "num_experts_per_tok": 6,
    "moe_layer_freq": 1, "first_k_dense_replace": 1, "norm_topk_prob": True,
    "scoring_func": "sigmoid", "seq_aux": True, "num_key_value_heads": 16,
    "hidden_act": "silu", "rms_norm_eps": 1e-05, "rope_theta": 800000, "rope_scaling": None,
    "attention_bias": False, "tie_word_embeddings": False}


@pytest.mark.parametrize("trace", ["0", "1"])
def test_caption_program_is_correct(trace):
    p, out = run(CELL, trace=trace)
    assert p.returncode == 0, p.stderr[-3000:]
    check_line(out, p.stderr, trace == "1")
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("extra", [("--control", "fp8_e4m3"), ("--fault", "frozen_state"),
                                   ("--fault", "half_batch"), ("--fault", "half_loss")],
                         ids=["fp8", "frozen_state", "half_batch", "half_loss"])
def test_caption_control_and_faults_fail(extra):
    p, out = run(CELL, *extra)
    assert p.returncode == 0, p.stderr[-3000:]
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("extra,correct", [((), True), (("--fault", "no_exchange"), False)],
                         ids=["program", "no_exchange"])
def test_simclr_on_four_ranks(extra, correct):
    p, out = run(X4, *extra)
    assert p.returncode == 0, p.stderr[-3000:]
    assert out["device"]["count"] == 4
    assert out["correct"] is correct, out["checks"]


def test_the_configuration_keeps_the_published_keys():
    entry = {c["name"]: c for c in spec.benchmark()["configs"]}["kimi-vl-a3b-glimpse-cap"]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert entry["reduced"] == ["n_routed_experts", "vocab_size"]
    for key, value in PUBLISHED.items():
        if key in entry["reduced"]:
            assert cfg["published"][key] == value and cfg[key] < value
        else:
            assert cfg[key] == value, key
    assert cfg["n_routed_experts"] == 8 and cfg["vocab_size"] == 163840 // 8
