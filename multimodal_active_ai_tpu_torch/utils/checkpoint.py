"""Checkpoints of the drivers, and JAX weights carried across.

* :func:`from_jax_variables` maps the JAX ``SimCLRModule`` variables
  (nested dicts of numpy arrays) onto this package's ``state_dict``, which is
  the reference torch layout (``f.conv1.weight`` … ``g.layers.2.bias``). It
  is the port's own copy of the JAX package's
  ``export_torch_simclr_state_dict``: convs HWIO → OIHW, Dense kernels
  transposed, and ``Dense_0``'s rows permuted from the NHWC flatten to the
  NCHW flatten. Variables of a JAX model built with ``stat_fusion`` (the
  ``FusedConv1x1BN`` Bottleneck layout) are first mapped to the unfused
  layout, and ``norm_kind='bn_fused'``'s ``FusedStatsBatchNorm_k`` slots read
  as the ``BatchNorm_k`` they replace, so every form gives the same
  ``state_dict``.
* :func:`from_jax_dqn_variables` maps the JAX ``DQN`` (the RLS saccade
  policy: the same trunk, heads ``g_x``/``g_y``) the same way.
* :func:`from_jax_probe_variables` and :func:`from_jax_detr_variables` do
  the same for the linear probe and the DETR classifier: the port's copies
  of ``export_torch_classifier_state_dict`` and
  ``export_torch_detr_state_dict`` (the reference ``linear.*`` and
  ``detr_CLA`` layouts, which are the port's ``state_dict``s).
* :func:`from_jax_text_variables`, :func:`from_jax_captioner_variables`
  and :func:`from_jax_caption_variables` do the same for the text tower,
  the caption decoder and the caption probe's two towers (its image head
  permuted per fixation block, as the probe's kernel is).
* :func:`from_jax_legacy_resnet_variables` and
  :func:`from_jax_resnet1d_variables` do the same for the legacy
  15-channel ResNet and the 1-D ResNet (kernels HWIO → OIHW and WIO → OIW,
  the 1-D head's first Dense permuted from the L-major flatten to the
  C-major one).
* :class:`AsyncCheckpointer` writes a payload on a background thread from
  a host snapshot taken on the caller's thread.
* :func:`load_simclr_backbone` puts a SimCLR ``state_dict``'s encoder ``f``
  into a DETR backbone with FrozenBatchNorm buffers.
* :func:`save_checkpoint` / :func:`load_checkpoint` write and read a
  driver's payload with ``torch.save`` (SimCLR: ``epoch``, ``step``,
  ``state_dict``, ``best_prec1``, ``optimizer``, the loss/top-1/top-5
  histories and ``total_time``; probe and DETR: the reference's four keys
  ``epoch``, ``state_dict``, ``best_prec1``, ``optimizer``; the RLS
  driver's DQN file: ``epoch``, ``step``, ``policy_state_dict``,
  ``target_state_dict``; the caption probe: ``epoch``, ``state_dict``,
  ``vocab_size`` and ``vocab_words_u8``), plus a copy under the best-model
  name. :func:`load_checkpoint` also reads the JAX package's flax msgpack
  files (:mod:`~multimodal_active_ai_tpu_torch.utils.flax_msgpack`), and
  :func:`simclr_state_dict` turns a JAX SimCLR payload into this
  package's ``state_dict``.
* :func:`resume_jax_simclr`, :func:`resume_jax_probe`,
  :func:`resume_jax_detr` and :func:`jax_dqn_state_dicts` resume a
  driver from the JAX package's own checkpoint of it: the weights through
  the maps above, the optax state through
  :func:`~multimodal_active_ai_tpu_torch.train.optimizers.load_optax_state`
  with the same maps, the JAX drivers' rules on what carries. A payload
  that lacks a key the JAX driver reads, or whose trees are not this
  model's, raises ``ValueError``.
"""

from __future__ import annotations

import os
import shutil
import threading
from collections import OrderedDict
from typing import Any

import numpy as np
import torch

from multimodal_active_ai_tpu_torch.models.conv_bn import is_fused_layout, unfuse_variables
from multimodal_active_ai_tpu_torch.models.norm import FrozenBatchNorm
from multimodal_active_ai_tpu_torch.train.optimizers import load_optax_state
from multimodal_active_ai_tpu_torch.utils import flax_msgpack


def _conv_hwio_to_oihw(k) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _sorted_slots(tree: dict, prefix: str) -> list[str]:
    """Traced flax submodule slots (``Conv_0``, ``BatchNorm_1``, ...) in
    trace order."""
    return sorted([k for k in tree if k.startswith(prefix)],
                  key=lambda s: int(s.rsplit("_", 1)[1]))


def _has_downsample(block_p: dict, convs: list[str]) -> bool:
    """A traced ResNet block has a downsample iff its LAST conv is a 1×1
    reading the block input (BasicBlock 2 main convs, Bottleneck 3; a
    bottleneck's conv3 is also 1×1 but reads the hidden width)."""
    c_in_first = np.shape(block_p[convs[0]]["kernel"])[2]
    last = np.shape(block_p[convs[-1]]["kernel"])
    return len(convs) >= 3 and last[2] == c_in_first and last[:2] == (1, 1)


def _as_batchnorm_slots(tree):
    """``FusedStatsBatchNorm_k`` → ``BatchNorm_k`` throughout ``tree``: the
    two kinds hold the same variables, and a block uses one kind."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        name = "BatchNorm_" + k[len(_FUSED_BN):] if k.startswith(_FUSED_BN) else k
        if name in out or (name != k and name in tree):
            raise ValueError(f"both {k} and {name} in one module")
        out[name] = _as_batchnorm_slots(v)
    return out


_FUSED_BN = "FusedStatsBatchNorm_"


def linear_on_flattened_conv(kernel, chw: tuple[int, int, int]) -> np.ndarray:
    """A flax Dense kernel ``(H·W·C, out)`` consuming the NHWC flatten →
    the torch Linear weight ``(out, C·H·W)`` consuming the NCHW flatten."""
    c, h, w = chw
    kernel = np.asarray(kernel)
    out_dim = kernel.shape[1]
    return np.ascontiguousarray(
        np.transpose(kernel.reshape(h, w, c, out_dim), (3, 2, 0, 1))
        .reshape(out_dim, c * h * w))


def _from_jax_encoder_and_heads(params: dict, batch_stats: dict | None,
                                heads: tuple[str, ...]) -> "OrderedDict[str, torch.Tensor]":
    """The encoder ``f`` and the ``MLP`` heads named ``heads`` of a JAX
    module's variables → the port's ``state_dict`` (``f.*``,
    ``<head>.layers.{0,2}.*``); a head missing from ``params`` is skipped.
    With ``batch_stats=None`` only the parameters are mapped (any tree in
    the parameters' layout, such as an optimizer's moments): every map is
    a pure reordering, so moments map as the weights do."""
    params = _as_batchnorm_slots(params)
    stats = _as_batchnorm_slots(batch_stats) if batch_stats is not None else {}
    if is_fused_layout(params):
        params, stats = unfuse_variables(params, stats)
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()

    def put(key, value, dtype=np.float32):
        sd[key] = torch.from_numpy(np.array(value, dtype=dtype))

    def put_bn(tkey, p_bn, s_bn):
        _put_bn(sd, tkey, p_bn, s_bn if batch_stats is not None else None)

    f_params, f_stats = params["f"], stats.get("f", {})
    put("f.conv1.weight", _conv_hwio_to_oihw(f_params["conv1"]["kernel"]))
    put_bn("f.bn1", f_params["bn1"], f_stats.get("bn1"))
    for name in f_params:
        if not name.startswith("layer"):
            continue
        stage, idx = name[5:].split("_")
        prefix = f"f.layer{stage}.{idx}."
        block_p, block_s = f_params[name], f_stats.get(name, {})
        convs = _sorted_slots(block_p, "Conv_")
        bns = _sorted_slots(block_p, "BatchNorm_")
        has_down = _has_downsample(block_p, convs)
        for j in range(len(convs) - (1 if has_down else 0)):
            put(f"{prefix}conv{j + 1}.weight",
                _conv_hwio_to_oihw(block_p[convs[j]]["kernel"]))
            put_bn(f"{prefix}bn{j + 1}", block_p[bns[j]], block_s.get(bns[j]))
        if has_down:
            put(prefix + "downsample.0.weight",
                _conv_hwio_to_oihw(block_p[convs[-1]]["kernel"]))
            put_bn(prefix + "downsample.1", block_p[bns[-1]], block_s.get(bns[-1]))

    for head in heads:
        if head not in params:
            continue
        g = params[head]
        k0 = np.asarray(g["Dense_0"]["kernel"])
        feat_c = k0.shape[0] // 16      # the encoder's spatial output is 4×4
        put(f"{head}.layers.0.weight", linear_on_flattened_conv(k0, (feat_c, 4, 4)))
        put(f"{head}.layers.0.bias", g["Dense_0"]["bias"])
        put(f"{head}.layers.2.weight", np.asarray(g["Dense_1"]["kernel"]).T)
        put(f"{head}.layers.2.bias", g["Dense_1"]["bias"])
    return sd


def _put_bn(sd: dict, key: str, p_bn: dict, s_bn: dict | None) -> None:
    """A flax BatchNorm's ``scale``/``bias`` and, unless ``s_bn`` is None,
    its ``mean``/``var`` (``num_batches_tracked`` an int64 zero) under
    ``key``."""
    sd[key + ".weight"] = _f32(p_bn["scale"])
    sd[key + ".bias"] = _f32(p_bn["bias"])
    if s_bn is not None:
        sd[key + ".running_mean"] = _f32(s_bn["mean"])
        sd[key + ".running_var"] = _f32(s_bn["var"])
        sd[key + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _conv_wio_to_oiw(k) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(k), (2, 1, 0)))


def _from_jax_plain_resnet(params: dict, batch_stats: dict | None,
                           conv) -> "OrderedDict[str, torch.Tensor]":
    """The trunk of a JAX ``LegacyResNet`` or ``ResNet1d`` (``conv1``,
    ``bn1``, ``layer{s}_{i}``) → ``conv1``, ``bn1``, ``layer{s}.{i}.conv{k}``/
    ``bn{k}`` and ``shortcut.{0,1}``, each kernel through ``conv``. A block
    whose first kernel is 1 tap wide is a bottleneck (three main convs),
    else basic (two); a conv beyond those is the shortcut's."""
    stats = batch_stats or {}
    with_stats = batch_stats is not None
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()
    sd["conv1.weight"] = _f32(conv(params["conv1"]["kernel"]))
    _put_bn(sd, "bn1", params["bn1"], stats.get("bn1") if with_stats else None)
    for name in sorted((k for k in params if k.startswith("layer")),
                       key=lambda k: tuple(int(x) for x in k[5:].split("_"))):
        stage, idx = name[5:].split("_")
        block_p, block_s = params[name], stats.get(name, {})
        convs = _sorted_slots(block_p, "Conv_")
        bns = _sorted_slots(block_p, "BatchNorm_")
        n_main = 3 if np.shape(block_p[convs[0]]["kernel"])[0] == 1 else 2
        keys = [f"conv{j + 1}" for j in range(n_main)] + ["shortcut.0"]
        norms = [f"bn{j + 1}" for j in range(n_main)] + ["shortcut.1"]
        for c, b, ck, bk in zip(convs, bns, keys, norms):
            sd[f"layer{stage}.{idx}.{ck}.weight"] = _f32(conv(block_p[c]["kernel"]))
            _put_bn(sd, f"layer{stage}.{idx}.{bk}", block_p[b],
                    block_s.get(b) if with_stats else None)
    return sd


def from_jax_legacy_resnet_variables(params: dict, batch_stats: dict | None
                                     ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``LegacyResNet`` variables (``models/resnet_legacy.py``) → the
    port's ``LegacyResNet`` ``state_dict``: convs HWIO → OIHW, BatchNorm
    ``scale``/``bias``/``mean``/``var`` (``batch_stats=None``: parameters
    only)."""
    return _from_jax_plain_resnet(params, batch_stats, _conv_hwio_to_oihw)


def from_jax_resnet1d_variables(params: dict, batch_stats: dict | None
                                ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``ResNet1d`` variables → the port's ``ResNet1d`` ``state_dict``:
    convs ``(W, I, O)`` → ``(O, I, W)``; the head's ``Dense_0`` rows, which
    read the ``(L', C)`` map flattened L-major, permuted to the C-major
    flatten (:func:`linear_on_flattened_conv` on a ``(C, 1, L')`` map),
    ``Dense_1`` transposed."""
    sd = _from_jax_plain_resnet(params, batch_stats, _conv_wio_to_oiw)
    # the trunk's output channels: the last norm's (its last block's output)
    channels = next(v for k, v in reversed(sd.items()) if k.endswith(".bias")).shape[0]
    k0 = np.asarray(params["Dense_0"]["kernel"])
    sd["linear1.weight"] = _f32(linear_on_flattened_conv(
        k0, (channels, 1, k0.shape[0] // channels)))
    sd["linear1.bias"] = _f32(params["Dense_0"]["bias"])
    sd["linear2.weight"] = _f32(np.asarray(params["Dense_1"]["kernel"]).T)
    sd["linear2.bias"] = _f32(params["Dense_1"]["bias"])
    return sd


def from_jax_variables(params: dict, batch_stats: dict | None
                       ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``SimCLRModule`` variables → this package's ``state_dict``.

    Values are float32 tensors; ``num_batches_tracked`` is an int64 zero,
    as the reference torch checkpoints carry it. Either Bottleneck layout
    and either BatchNorm kind is accepted (their slots are mapped first).
    ``batch_stats=None`` maps a parameter-layout tree alone (the
    parameters' entries only; an optimizer's moments).
    """
    return _from_jax_encoder_and_heads(params, batch_stats, ("g",))


def from_jax_dqn_variables(params: dict, batch_stats: dict | None
                           ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``DQN`` variables (``norm_kind='bn'``) → the port DQN's
    ``state_dict``: the trunk as :func:`from_jax_variables` maps ``f``, and
    the heads ``g_x``/``g_y`` as it maps ``g`` (each ``Dense_0`` permuted
    from the NHWC flatten to the C-major one)."""
    return _from_jax_encoder_and_heads(params, batch_stats, ("g_x", "g_y"))


def _per_fixation_kernel(kernel, num_fixations: int, what: str) -> np.ndarray:
    """A flax Dense kernel ``(F·16·C, out)`` over ``F`` concatenated NHWC
    feature blocks → the torch weight ``(out, F·C·16)`` over C-major
    blocks (each block permuted as :func:`linear_on_flattened_conv` does)."""
    kernel = np.asarray(kernel)
    per_fix = kernel.shape[0] // num_fixations
    if per_fix * num_fixations != kernel.shape[0] or per_fix % 16:
        raise ValueError(f"{what} kernel {kernel.shape} does not split into "
                         f"{num_fixations} blocks of 16·C rows")
    return np.concatenate([linear_on_flattened_conv(kernel[f * per_fix:(f + 1) * per_fix],
                                                    (per_fix // 16, 4, 4))
                           for f in range(num_fixations)], axis=1)


def from_jax_probe_variables(params: dict, num_fixations: int
                             ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``LogisticRegression`` params → the probe's ``state_dict``
    (``linear.weight`` ``(out, F·C·16)``, ``linear.bias``): each fixation's
    block of the kernel is permuted from the NHWC flatten to the C-major
    one."""
    w = _per_fixation_kernel(params["Dense_0"]["kernel"], num_fixations, "probe")
    return OrderedDict([("linear.weight", torch.from_numpy(w.astype(np.float32))),
                        ("linear.bias", torch.from_numpy(
                            np.array(params["Dense_0"]["bias"], np.float32)))])


def _mha_from_flax(tree: dict) -> dict[str, np.ndarray]:
    """flax ``MultiHeadDotProductAttention`` params → the packed
    ``in_proj_weight`` (rows q, k, v; ``y = W x``), ``in_proj_bias`` and
    ``out_proj``."""
    d = np.asarray(tree["out"]["bias"]).shape[0]
    qkv = ("query", "key", "value")
    return {
        "in_proj_weight": np.concatenate(
            [np.asarray(tree[n]["kernel"]).reshape(d, d).T for n in qkv], 0),
        "in_proj_bias": np.concatenate([np.asarray(tree[n]["bias"]).reshape(d) for n in qkv]),
        "out_proj.weight": np.asarray(tree["out"]["kernel"]).reshape(d, d).T,
        "out_proj.bias": np.asarray(tree["out"]["bias"]),
    }


def _f32(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value, dtype=np.float32))


def _put_dense(sd: dict, key: str, dense: dict) -> None:
    sd[key + ".weight"] = _f32(np.asarray(dense["kernel"]).T)
    sd[key + ".bias"] = _f32(dense["bias"])


def _put_layer(sd: dict, layer: dict, prefix: str, attns, n_norms: int) -> None:
    """One flax transformer layer into ``sd`` under ``prefix``: each
    attention of ``attns`` (``(path of slots, torch name)``), ``Dense_0/1``
    ↔ ``linear1/2`` and ``LayerNorm_k`` ↔ ``norm{k+1}``."""
    for path, name in attns:
        tree = layer
        for slot in path:
            tree = tree[slot]
        for key, v in _mha_from_flax(tree).items():
            sd[f"{prefix}.{name}.{key}"] = _f32(v)
    for j in (0, 1):
        _put_dense(sd, f"{prefix}.linear{j + 1}", layer[f"Dense_{j}"])
    for n in range(n_norms):
        sd[f"{prefix}.norm{n + 1}.weight"] = _f32(layer[f"LayerNorm_{n}"]["scale"])
        sd[f"{prefix}.norm{n + 1}.bias"] = _f32(layer[f"LayerNorm_{n}"]["bias"])


_ENCODER_ATTN = [(("_MHA_0", "MultiHeadDotProductAttention_0"), "self_attn")]


def from_jax_transformer_variables(tr: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``Transformer`` params → the port's ``Transformer`` ``state_dict``
    (flax tracing order: ``Dense_0/1`` ↔ ``linear1/2``, ``LayerNorm_k`` ↔
    ``norm{k+1}``, ``_MHA_0/1`` ↔ ``self_attn``/``multihead_attn``; the
    pre-norm encoder's final ``LayerNorm_0`` ↔ ``encoder.norm``)."""
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()
    for name in tr:
        i = name.split("_")[-1]
        if name.startswith("TransformerEncoderLayer_"):
            _put_layer(sd, tr[name], f"encoder.layers.{i}", _ENCODER_ATTN, 2)
        elif name.startswith("TransformerDecoderLayer_"):
            _put_layer(sd, tr[name], f"decoder.layers.{i}",
                       _ENCODER_ATTN + [(("_MHA_1", "MultiHeadDotProductAttention_0"),
                                         "multihead_attn")], 3)
    sd["decoder.norm.weight"] = _f32(tr["decoder_norm"]["scale"])
    sd["decoder.norm.bias"] = _f32(tr["decoder_norm"]["bias"])
    if "LayerNorm_0" in tr:
        sd["encoder.norm.weight"] = _f32(tr["LayerNorm_0"]["scale"])
        sd["encoder.norm.bias"] = _f32(tr["LayerNorm_0"]["bias"])
    return sd


def from_jax_text_variables(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``TextEncoder`` params → the port's ``TextEncoder`` ``state_dict``:
    ``Embed_0`` ↔ ``embed`` (passed straight through), each
    ``TransformerEncoderLayer_i`` ↔ ``layers.i``, the top ``Dense_0`` ↔
    ``proj``."""
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()
    sd["embed.weight"] = _f32(params["Embed_0"]["embedding"])
    for name in _sorted_slots(params, "TransformerEncoderLayer_"):
        _put_layer(sd, params[name], f"layers.{name.split('_')[-1]}", _ENCODER_ATTN, 2)
    _put_dense(sd, "proj", params["Dense_0"])
    return sd


def from_jax_captioner_variables(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``GlimpseCaptioner`` params → the port's ``state_dict``:
    ``Dense_0`` ↔ ``memory_proj``, ``Embed_0`` ↔ ``embed``, each
    ``_CausalDecoderLayer_i`` ↔ ``layers.i`` (its attentions
    ``MultiHeadDotProductAttention_0/1`` ↔ ``self_attn``/``multihead_attn``),
    ``LayerNorm_0`` ↔ ``norm`` and ``Dense_1`` ↔ ``head``."""
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()
    _put_dense(sd, "memory_proj", params["Dense_0"])
    sd["embed.weight"] = _f32(params["Embed_0"]["embedding"])
    for name in _sorted_slots(params, "_CausalDecoderLayer_"):
        _put_layer(sd, params[name], f"layers.{name.split('_')[-1]}",
                   [(("MultiHeadDotProductAttention_0",), "self_attn"),
                    (("MultiHeadDotProductAttention_1",), "multihead_attn")], 3)
    sd["norm.weight"] = _f32(params["LayerNorm_0"]["scale"])
    sd["norm.bias"] = _f32(params["LayerNorm_0"]["bias"])
    _put_dense(sd, "head", params["Dense_1"])
    return sd


def from_jax_caption_variables(params: dict, num_fixations: int
                               ) -> "OrderedDict[str, torch.Tensor]":
    """The JAX caption probe's ``{"image_head", "text"}`` params → the port's
    ``CaptionTowers`` ``state_dict``: ``image_head.layers.{0,2}.*`` (the
    head's ``Dense_0`` permuted per fixation block from the NHWC flatten to
    the C-major one) and ``text.*`` (:func:`from_jax_text_variables`)."""
    head = params["image_head"]
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()
    sd["image_head.layers.0.weight"] = _f32(
        _per_fixation_kernel(head["Dense_0"]["kernel"], num_fixations, "image head"))
    sd["image_head.layers.0.bias"] = _f32(head["Dense_0"]["bias"])
    _put_dense(sd, "image_head.layers.2", head["Dense_1"])
    for key, value in from_jax_text_variables(params["text"]).items():
        sd["text." + key] = value
    return sd


def from_jax_detr_variables(params: dict, batch_stats: dict | None
                            ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``DETR`` variables (FrozenBatchNorm backbone) → the port's DETR
    ``state_dict``, the reference ``detr_CLA`` layout of
    ``export_torch_detr_state_dict``: ``backbone.0.body.*`` with the four
    FrozenBatchNorm buffers (no ``num_batches_tracked``), the transformer's
    packed attention projections, ``input_proj.weight`` ``(out, C·16, 1)``
    over the C-major flatten, ``query_embed``, ``class_embed`` and, for the
    learned embedding, ``backbone.1.{row,col}_embed.weight``.
    ``batch_stats=None`` maps a parameter-layout tree alone (no buffers; an
    optimizer's moments)."""
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()

    def put(key, value):
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    def put_frozen(tkey, s_bn):
        if s_bn is None:
            return
        for name, slot in (("weight", "weight"), ("bias", "bias"),
                           ("running_mean", "mean"), ("running_var", "var")):
            put(f"{tkey}.{name}", s_bn[slot])

    bb = "backbone.0.body."
    f_params = params["backbone_f"]
    f_stats = {} if batch_stats is None else batch_stats.get("backbone_f")
    if f_stats is None:
        raise ValueError("from_jax_detr_variables carries FrozenBatchNorm backbones; "
                         "these variables have no backbone statistics")
    put(bb + "conv1.weight", _conv_hwio_to_oihw(f_params["conv1"]["kernel"]))
    put_frozen(bb + "bn1", f_stats.get("bn1"))
    for name in f_params:
        if not name.startswith("layer"):
            continue
        stage, idx = name[5:].split("_")
        prefix = f"{bb}layer{stage}.{idx}."
        block_p, block_s = f_params[name], f_stats.get(name, {})
        convs = _sorted_slots(block_p, "Conv_")
        fbns = _sorted_slots(block_s, "FrozenBatchNorm_") or [None] * len(convs)
        has_down = _has_downsample(block_p, convs)
        for j in range(len(convs) - (1 if has_down else 0)):
            put(f"{prefix}conv{j + 1}.weight", _conv_hwio_to_oihw(block_p[convs[j]]["kernel"]))
            put_frozen(f"{prefix}bn{j + 1}", block_s.get(fbns[j]))
        if has_down:
            put(prefix + "downsample.0.weight", _conv_hwio_to_oihw(block_p[convs[-1]]["kernel"]))
            put_frozen(prefix + "downsample.1", block_s.get(fbns[-1]))

    k = np.asarray(params["input_proj"]["kernel"])              # (16·C, hidden)
    put("input_proj.weight", linear_on_flattened_conv(k, (k.shape[0] // 16, 4, 4))[:, :, None])
    put("input_proj.bias", params["input_proj"]["bias"])
    put("query_embed.weight", params["query_embed"])
    put("class_embed.weight", np.asarray(params["class_embed"]["kernel"]).T)
    put("class_embed.bias", params["class_embed"]["bias"])

    for key, value in from_jax_transformer_variables(params["transformer"]).items():
        sd["transformer." + key] = value
    pos = params.get("pos_embed")
    if isinstance(pos, dict) and "row_embed" in pos:
        put("backbone.1.row_embed.weight", pos["row_embed"]["embedding"])
        put("backbone.1.col_embed.weight", pos["col_embed"]["embedding"])
    return sd


def encoder_state_dict(simclr_sd: dict) -> "OrderedDict[str, torch.Tensor]":
    """The encoder ``f`` of a SimCLR ``state_dict``, its ``f.`` prefix
    stripped (the projector ``g`` is dropped)."""
    return OrderedDict((k[2:], v) for k, v in simclr_sd.items() if k.startswith("f."))


def load_simclr_backbone(body: torch.nn.Module, simclr_sd: dict) -> None:
    """Load a SimCLR ``state_dict``'s encoder into a DETR backbone ``body``
    (``backbone.py:199-213``): BatchNorm ``weight``/``bias``/``running_*``
    become the FrozenBatchNorm buffers, ``num_batches_tracked`` is dropped.
    A GroupNorm backbone has no slot for the statistics and raises."""
    if not any(isinstance(m, FrozenBatchNorm) for m in body.modules()):
        raise ValueError("--backbone-norm group cannot load a FrozenBatchNorm-layout "
                         "checkpoint; use --backbone-norm frozen for pretrained backbones")
    body.load_state_dict(OrderedDict(
        (k, v) for k, v in encoder_state_dict(simclr_sd).items()
        if not k.endswith(".num_batches_tracked")))


def save_checkpoint(payload: dict[str, Any], is_best: bool,
                    filename: str = "checkpoint.pth.tar",
                    best_filename: str = "model_best.pth.tar") -> None:
    """Write ``payload`` with ``torch.save`` (atomically: temp file, then
    rename) and copy it to ``best_filename`` when ``is_best``."""
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    tmp = filename + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, filename)
    if is_best:
        print("Saving a new best model with precesion {}".format(payload.get("best_prec1")))
        os.makedirs(os.path.dirname(os.path.abspath(best_filename)), exist_ok=True)
        shutil.copyfile(filename, best_filename)


def _host_snapshot(obj):
    """A copy of ``obj`` (nested dicts, lists and tuples) in which every
    tensor is a new CPU tensor, complete when this returns: later in-place
    updates of the originals (the next optimizer step) do not reach it."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, _host_snapshot(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_snapshot(v) for v in obj)
    return obj


class AsyncCheckpointer:
    """Checkpoint writes off the epoch loop's thread.

    Port of the JAX package's ``AsyncCheckpointer``
    (``utils/checkpoint.py:65-120``): :meth:`save` snapshots the payload to
    host memory on the caller's thread (``state_dict()`` tensors are the
    live ones, which the next step updates in place) and hands
    ``torch.save``, the atomic rename and the best-model copy
    (:func:`save_checkpoint`) to one background thread. At most one save
    is in flight: a second :meth:`save` first waits for the previous one, so
    checkpoints land in order. :meth:`wait` blocks until the save in flight
    is on disk and re-raises its error on the caller's thread; call it
    before reading the files or returning."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, payload: dict[str, Any], is_best: bool,
             filename: str = "checkpoint.pth.tar",
             best_filename: str = "model_best.pth.tar") -> None:
        self.wait()
        snapshot = _host_snapshot(payload)

        def work():
            try:
                save_checkpoint(snapshot, is_best, filename, best_filename)
            except BaseException as exc:  # noqa: BLE001 - re-raised by wait()
                self._error = exc

        self._thread = threading.Thread(target=work, name="checkpoint-save", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err


_ZIP_MAGIC = b"PK\x03\x04"


def is_torch_file(filename: str) -> bool:
    """Whether ``filename`` is a ``torch.save`` file (a zip archive) rather
    than a flax msgpack checkpoint of the JAX package."""
    with open(filename, "rb") as f:
        return f.read(4) == _ZIP_MAGIC


def load_checkpoint(filename: str, map_location: torch.device | str = "cpu") -> dict:
    """Read a payload written by :func:`save_checkpoint` (tensors, numbers,
    lists and dicts only: loaded with ``weights_only=True``) or a JAX
    package checkpoint (flax msgpack, told apart by its first bytes; its
    tree of numpy arrays comes back as flax restores it)."""
    if is_torch_file(filename):
        return torch.load(filename, map_location=map_location, weights_only=True)
    return flax_msgpack.read_file(filename)


def simclr_state_dict(payload: dict) -> "OrderedDict[str, torch.Tensor]":
    """The port-layout SimCLR ``state_dict`` of a loaded checkpoint: a
    torch payload's ``state_dict`` (or the payload itself), or a JAX
    payload's ``state_dict: {params, batch_stats}`` (either Bottleneck
    layout, either BatchNorm kind) through :func:`from_jax_variables`. Any
    other key of a JAX payload (optimizer state, histories) is ignored."""
    sd = payload.get("state_dict", payload)
    if isinstance(sd, dict) and "params" in sd and "batch_stats" in sd:
        return from_jax_variables(sd["params"], sd["batch_stats"])
    return sd


# ---------------------------------------------------------------------------
# Resuming a driver from the JAX package's checkpoint of it


def require_keys(payload, keys, path: str, what: str) -> None:
    """Refuse a payload that lacks a key the JAX driver reads, naming it."""
    missing = [k for k in keys if not isinstance(payload, dict) or k not in payload]
    if missing:
        raise ValueError(f"'{path}' is not a JAX package {what} checkpoint: it has no "
                         + ", ".join(repr(k) for k in missing))


def load_converted(module: torch.nn.Module, convert, path: str, what: str) -> None:
    """``module.load_state_dict(convert())``, strict; a tree that is not
    this model's (a missing slot, another shape) raises ``ValueError``, as
    the JAX package's ``restore_like`` refuses it."""
    try:
        module.load_state_dict(convert())
    except (KeyError, TypeError, IndexError, RuntimeError) as err:
        raise ValueError(f"'{path}' does not hold this model's {what} variables: "
                         f"{type(err).__name__}: {err}") from err


def _load_optimizer(optimizer, model, opt_state, kind, to_port, path, clipped=False):
    try:
        return load_optax_state(optimizer, model, opt_state, kind, to_port, clipped)
    except (KeyError, TypeError, IndexError, ValueError) as err:
        raise ValueError(f"'{path}': its optax state does not match this optimizer: "
                         f"{err}") from err


SIMCLR_KEYS = ("epoch", "step", "state_dict", "best_prec1", "optimizer", "loss_history",
               "top1_acc_history", "top5_acc_history", "total_time")


def resume_jax_simclr(payload: dict, model: torch.nn.Module, optimizer, kind: str,
                      want_fused: bool, path: str) -> int | None:
    """Load a JAX SimCLR payload into ``model`` and ``optimizer`` (built by
    ``get_optimizer(kind)``), by the JAX driver's rule
    (``contrastive_learning.py:184-220``): the optax state carries when the
    file's Bottleneck layout (``is_fused_layout``) is the one the JAX driver
    builds from the same ``--arch``/``--stat-fusion`` (``want_fused``);
    otherwise only the weights convert and the optimizer starts fresh.
    Returns the optimizer's schedule count, or None when it starts fresh
    (the caller keeps ``step`` and restarts the schedule at 0)."""
    require_keys(payload, SIMCLR_KEYS, path, "SimCLR")
    require_keys(payload["state_dict"], ("params", "batch_stats"), path, "SimCLR")
    params = payload["state_dict"]["params"]
    load_converted(model, lambda: from_jax_variables(params, payload["state_dict"][
        "batch_stats"]), path, "SimCLR")
    if is_fused_layout(params) != want_fused:
        return None
    return _load_optimizer(optimizer, model, payload["optimizer"], kind,
                           lambda tree: from_jax_variables(tree, None), path)


def resume_jax_probe(payload: dict, probe: torch.nn.Module, optimizer, kind: str,
                     num_fixations: int, path: str) -> int | None:
    """Load a JAX linear-probe payload (``state_dict`` = the probe's params)
    and its optax state (``representation_evaluation.py:159-169``).
    Returns the schedule count."""
    require_keys(payload, ("epoch", "state_dict", "best_prec1", "optimizer"), path, "probe")
    load_converted(probe, lambda: from_jax_probe_variables(payload["state_dict"],
                                                            num_fixations), path, "probe")
    return _load_optimizer(optimizer, probe, payload["optimizer"], kind,
                           lambda tree: from_jax_probe_variables(tree, num_fixations), path)


def fill_masked(tree, like):
    """``tree`` with every empty ``{}`` leaf where ``like`` has an array
    replaced by zeros of that shape: ``optax.masked`` writes a group's
    moments as the whole parameter tree with the other groups' leaves
    empty."""
    if isinstance(like, dict):
        return {k: fill_masked(tree.get(k, {}), v) for k, v in like.items()}
    if isinstance(tree, dict) and not tree:
        return np.zeros(np.shape(like), np.float32)
    return tree


def resume_jax_detr(payload: dict, model: torch.nn.Module, optimizer, clipped: bool,
                    path: str) -> int | None:
    """Load a JAX DETR payload (``{params, batch_stats}``, FrozenBatchNorm
    backbone) and the optax state of ``make_detr_optimizer``'s chain
    (``detr_image_classification.py:226-236``): each AdamW group's moments
    and count, the frozen group and the clip holding none. ``clipped`` is
    whether the chain starts with the clip (``--clip_max_norm > 0``).
    Returns the groups' schedule count."""
    require_keys(payload, ("epoch", "state_dict", "best_prec1", "optimizer"), path, "DETR")
    require_keys(payload["state_dict"], ("params", "batch_stats"), path, "DETR")
    params = payload["state_dict"]["params"]
    load_converted(model, lambda: from_jax_detr_variables(params, payload["state_dict"][
        "batch_stats"]), path, "DETR")
    return _load_optimizer(optimizer, model, payload["optimizer"], "detr",
                           lambda tree: from_jax_detr_variables(fill_masked(tree, params),
                                                                None), path, clipped)


def jax_dqn_state_dicts(payload: dict, path: str):
    """The port DQN ``state_dict``s of the policy and the target of a JAX
    RLS DQN payload, and its ``step`` (``detr_image_classification_rls.py:
    157-171``). The file holds no optimizer state: RMSprop starts fresh, as
    the JAX driver's does."""
    keys = ("policy_state_dict", "policy_batch_stats", "target_state_dict",
            "target_batch_stats")
    require_keys(payload, keys, path, "DQN")
    try:
        policy = from_jax_dqn_variables(payload[keys[0]], payload[keys[1]])
        target = from_jax_dqn_variables(payload[keys[2]], payload[keys[3]])
    except (KeyError, TypeError, IndexError) as err:
        raise ValueError(f"'{path}' does not hold DQN variables: "
                         f"{type(err).__name__}: {err}") from err
    return policy, target, int(payload.get("step", 0))
