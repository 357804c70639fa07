"""Every public name of the JAX package has its counterpart in the port.

Each module of ``multimodal_active_ai_tpu`` is read with ``ast`` (nothing is
imported, so no JAX), and each top-level public ``def`` and ``class`` must
exist under the same name in the port's module of the same path (or the
module ``MODULES`` maps it to), or be named in ``NAMES``: a counterpart
under another name, which must exist, or the reason none is needed. The
port's console scripts (the five drivers and the bench) are read from
``pyproject.toml``.
"""

import ast
import importlib
import os
import tomllib

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX, PORT = "multimodal_active_ai_tpu", "multimodal_active_ai_tpu_torch"

# JAX modules whose port counterpart has another path
MODULES = {
    "ops.pallas_retina": "ops.glimpse_sample",       # B1 glimpse_sample, B4 hat_sample
    "ops.pallas_bn": "ops.stat_sums",                # B2
    "ops.pallas_conv_bn": "ops.conv1x1_stats",       # B3
    "parallel.mesh": "parallel.distributed",
}

# "module:name" of the JAX package → "port.module:name" of its counterpart
# under another name, or "none: why" where the port needs none
NAMES = {
    "ops.image_ops:apply_color_twist": "ops.retina:_color_twist",
    "ops.pallas_retina:glimpse_sample_xla": "ops.glimpse_sample:glimpse_sample_plain",
    "ops.pallas_retina:hat_sample_xla": "ops.glimpse_sample:hat_sample_plain",
    "parallel.mesh:create_mesh": "parallel.distributed:initialize_distributed",
    "parallel.mesh:create_hybrid_mesh": "parallel.distributed:initialize_distributed",
    "parallel.mesh:local_batch_rows": "parallel.distributed:local_rows",
    "parallel.mesh:local_batch_slice": "parallel.distributed:local_rows",
    "parallel.mesh:batch_sharding": "none: each rank holds its own rows, nothing is sharded",
    "parallel.mesh:replicated_sharding": "none: parameters are ordinary per-rank tensors",
    "parallel.mesh:make_global_array": "none: no global array; the steps gather explicitly",
    "parallel.mesh:data_parallel_jit": "none: eager steps, no jit; parallel/collectives.py",
    "train.caption_probe:image_tower": "train.caption_probe:_embeddings",
    "train.optimizers:larc_scale": "train.optimizers:LARCAdam",
    "train.simclr_train:create_train_state": "train.simclr_train:TrainState",
    "train.simclr_train:unroll_from_env": "none: the eager fixation loop has no scan to unroll",
    "models.conv_bn:FusedConv1x1BN": "models.conv_bn:conv1x1_bn",
    "models.conv_bn:convert_stat_fusion_variables": "models.conv_bn:unfuse_variables",
    "data.native:decode_resize": "data.native:decode_batch",
    "utils.checkpoint:restore_like": "none: torch's load_state_dict restores in place",
    "utils.checkpoint:torch_linear_on_flattened_conv": "utils.checkpoint:linear_on_flattened_conv",
    "utils.checkpoint:flax_linear_on_flattened_conv": "utils.checkpoint:linear_on_flattened_conv",
    "utils.checkpoint:export_torch_simclr_state_dict": "utils.checkpoint:from_jax_variables",
    "utils.checkpoint:export_torch_classifier_state_dict":
        "utils.checkpoint:from_jax_probe_variables",
    "utils.checkpoint:export_torch_detr_state_dict": "utils.checkpoint:from_jax_detr_variables",
    "utils.checkpoint:save_torch_checkpoint": "utils.checkpoint:save_checkpoint",
    "utils.checkpoint:import_torch_checkpoint": "utils.checkpoint:load_checkpoint",
    "utils.checkpoint:import_torch_detr_checkpoint": "utils.checkpoint:load_checkpoint",
    "utils.checkpoint:import_torch_simclr_state_dict":
        "none: the port's state_dict is the reference layout",
    "utils.checkpoint:import_torch_classifier_state_dict":
        "none: the port's state_dict is the reference layout",
    "utils.checkpoint:import_torch_detr_state_dict":
        "none: the port's state_dict is the reference layout",
    "utils.meters:to_python_float": "none: float(tensor)",
    "utils.metrics:accuracy_topk": "utils.metrics:top_k_accuracy",
    "utils.rng:host_key_stream": "contrastive_learning:generator",
    "utils.rng:epoch_key_stream": "contrastive_learning:generator",
}


def _public(path: str) -> list[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")]


def _jax_names() -> list[tuple[str, str]]:
    out = []
    base = os.path.join(ROOT, JAX)
    for root, _, files in os.walk(base):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(root, f)
                mod = os.path.relpath(path, base)[:-3].replace(os.sep, ".")
                out += [(mod, name) for name in _public(path)]
    return sorted(out)


def _resolve(target: str):
    mod, name = target.split(":")
    return getattr(importlib.import_module(f"{PORT}.{mod}"), name)


def test_every_jax_public_name_has_a_port_counterpart():
    missing = []
    for mod, name in _jax_names():
        key = f"{mod}:{name}"
        if key in NAMES:
            continue
        port_mod = MODULES.get(mod, mod)
        try:
            _resolve(f"{port_mod}:{name}")
        except (ImportError, AttributeError):
            missing.append(key)
    assert not missing, f"no port counterpart and no entry in NAMES: {missing}"


@pytest.mark.parametrize("key", sorted(NAMES))
def test_the_name_map_is_true(key):
    """Each mapped JAX name exists in the JAX package and has no same-named
    port counterpart (else its entry would be idle), and each named
    counterpart exists in the port."""
    mod, name = key.split(":")
    assert (mod, name) in _jax_names()
    with pytest.raises((ImportError, AttributeError)):
        _resolve(f"{MODULES.get(mod, mod)}:{name}")
    target = NAMES[key]
    if not target.startswith("none: "):
        assert _resolve(target) is not None


def test_console_scripts_name_the_five_port_drivers():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    port = {k: v for k, v in scripts.items() if v.startswith(PORT + ".")}
    assert sorted(v.split(":")[0].split(".")[1] for v in port.values()) == sorted([
        "coco_captions_probe", "contrastive_learning", "detr_image_classification",
        "detr_image_classification_rls", "representation_evaluation", "bench"])
    for name, target in port.items():
        mod, attr = target.split(":")
        assert name.startswith("maai-torch-") and callable(
            getattr(importlib.import_module(mod), attr))
