"""Checkpoints of the SimCLR driver, and JAX weights carried across.

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
* :func:`save_checkpoint` / :func:`load_checkpoint` write and read the
  driver's payload (``epoch``, ``step``, ``state_dict``, ``best_prec1``,
  ``optimizer``, the loss/top-1/top-5 histories and ``total_time``) with
  ``torch.save``, as ``checkpoint.pth.tar`` plus a ``model_best.pth.tar``
  copy.
"""

from __future__ import annotations

import os
import shutil
from collections import OrderedDict
from typing import Any

import numpy as np
import torch

from multimodal_active_ai_tpu_torch.models.conv_bn import is_fused_layout, unfuse_variables


def _conv_hwio_to_oihw(k) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _sorted_slots(tree: dict, prefix: str) -> list[str]:
    """Traced flax submodule slots (``Conv_0``, ``BatchNorm_1``, ...) in
    trace order."""
    return sorted([k for k in tree if k.startswith(prefix)],
                  key=lambda s: int(s.split("_")[1]))


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


def from_jax_variables(params: dict, batch_stats: dict) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``SimCLRModule`` variables → this package's ``state_dict``.

    Values are float32 tensors; ``num_batches_tracked`` is an int64 zero,
    as the reference torch checkpoints carry it. Either Bottleneck layout
    and either BatchNorm kind is accepted (their slots are mapped first).
    """
    params, batch_stats = _as_batchnorm_slots(params), _as_batchnorm_slots(batch_stats)
    if is_fused_layout(params):
        params, batch_stats = unfuse_variables(params, batch_stats)
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()

    def put(key, value, dtype=np.float32):
        sd[key] = torch.from_numpy(np.array(value, dtype=dtype))

    def put_bn(tkey, p_bn, s_bn):
        put(tkey + ".weight", p_bn["scale"])
        put(tkey + ".bias", p_bn["bias"])
        put(tkey + ".running_mean", s_bn["mean"])
        put(tkey + ".running_var", s_bn["var"])
        put(tkey + ".num_batches_tracked", 0, np.int64)

    f_params, f_stats = params["f"], batch_stats["f"]
    put("f.conv1.weight", _conv_hwio_to_oihw(f_params["conv1"]["kernel"]))
    put_bn("f.bn1", f_params["bn1"], f_stats["bn1"])
    for name in f_params:
        if not name.startswith("layer"):
            continue
        stage, idx = name[5:].split("_")
        prefix = f"f.layer{stage}.{idx}."
        block_p, block_s = f_params[name], f_stats[name]
        convs = _sorted_slots(block_p, "Conv_")
        bns = _sorted_slots(block_p, "BatchNorm_")
        has_down = _has_downsample(block_p, convs)
        for j in range(len(convs) - (1 if has_down else 0)):
            put(f"{prefix}conv{j + 1}.weight",
                _conv_hwio_to_oihw(block_p[convs[j]]["kernel"]))
            put_bn(f"{prefix}bn{j + 1}", block_p[bns[j]], block_s[bns[j]])
        if has_down:
            put(prefix + "downsample.0.weight",
                _conv_hwio_to_oihw(block_p[convs[-1]]["kernel"]))
            put_bn(prefix + "downsample.1", block_p[bns[-1]], block_s[bns[-1]])

    if "g" in params:
        g = params["g"]
        k0 = np.asarray(g["Dense_0"]["kernel"])
        feat_c = k0.shape[0] // 16      # the encoder's spatial output is 4×4
        put("g.layers.0.weight", linear_on_flattened_conv(k0, (feat_c, 4, 4)))
        put("g.layers.0.bias", g["Dense_0"]["bias"])
        put("g.layers.2.weight", np.asarray(g["Dense_1"]["kernel"]).T)
        put("g.layers.2.bias", g["Dense_1"]["bias"])
    return sd


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


def load_checkpoint(filename: str, map_location: torch.device | str = "cpu") -> dict:
    """Read a payload written by :func:`save_checkpoint` (tensors, numbers,
    lists and dicts only: loaded with ``weights_only=True``)."""
    return torch.load(filename, map_location=map_location, weights_only=True)
