"""Driver configs and the argparse shim that builds their CLIs.

The port's own copy of ``multimodal_active_ai_tpu/config.py``
(``ContrastiveConfig``, ``EvalConfig``, ``DETRConfig``, ``RLSConfig``,
``add_args_from_dataclass``, ``parse_into``) and of the ``CaptionProbeConfig``
of its ``coco_captions_probe.py``: the same flag names and defaults, the
reference's underscore flags included (``--enc_layers``, ``--lr_backbone``,
``--clip_max_norm``), so a JAX command line runs here unchanged, plus
``--device``. Flags whose feature has not been ported raise
``NotImplementedError`` in the drivers (:func:`check_ported`), naming the
ROADMAP item. The file readers' own flags (``-j``, ``--canvas-cache``) have
no effect with ``--dataset synthetic``, as in the JAX drivers.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field, fields

MODEL_NAMES = ["ResNet10", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
               "ResNet152"]
DATASETS = ["mscoco", "imagenet", "synthetic"]
OPTIMIZERS = ["sgd", "adam", "lars"]


def _flag(*names, **kw):
    return field(default=kw.pop("default"), metadata={"names": names, **kw})


@dataclass
class ContrastiveConfig:
    """``Contrastive_Learning.parse()`` flags, plus the framework extensions."""

    data: str = _flag("data", default=None, positional=True,
                      help="path to MSCOCO or IMAGENET dataset")
    arch: str = _flag("--arch", "-a", default="ResNet18", choices=MODEL_NAMES)
    workers: int = _flag("-j", "--workers", default=4)
    epochs: int = _flag("--epochs", default=190)
    start_epoch: int = _flag("--start-epoch", default=0)
    batch_size: int = _flag("-b", "--batch-size", default=256)
    num_fixations: int = _flag("-f", "--num-fixations", default=10)
    lr: float = _flag("--lr", "--learning-rate", default=0.01)
    lrs: str = _flag("--lrs", "--learning-rate-scaling", default="linear")
    warmup_epochs: int = _flag("--warmup-epochs", default=10)
    momentum: float = _flag("--momentum", default=0.9)
    temperature: float = _flag("--temperature", default=0.05)
    weight_decay: float = _flag("--weight-decay", "--wd", default=1e-4)
    print_freq: int = _flag("--print-freq", "-p", default=10)
    resume: str = _flag("--resume", default="")
    optimizer: str = _flag("--optimizer", default="adam", choices=OPTIMIZERS)
    dataset: str = _flag("--dataset", default="mscoco", choices=DATASETS)
    color_augmentation: float = _flag("--color-augmentation", default=0.5)
    grid_mask_augmentation: float = _flag("--grid-mask-augmentation", default=0.0)
    gaussian_noise_augmentation: float = _flag("--gaussian-noise-augmentation", default=0.5)
    test: bool = _flag("-t", "--test", default=False, action="store_true")
    verbose: bool = _flag("-v", "--verbose", default=False, action="store_true")
    brightness: float = _flag("--brightness", default=1.0)
    contrast: float = _flag("--contrast", default=1.0)
    hue: float = _flag("--hue", default=90.0)
    saturation: float = _flag("--saturation", default=0.5)
    plot_training_history: bool = _flag("-pth", "--plot-training-history",
                                        default=False, action="store_true")
    # --- framework extensions (not in the reference CLI) ---
    canvas_size: int = _flag("--canvas-size", default=640,
                             help="source canvas edge")
    seed: int = _flag("--seed", default=15, help="base seed")
    bf16: bool = _flag("--bf16", default=True, action="store_true",
                       help="bfloat16 convolutions and products (autocast); "
                            "parameters and BN statistics stay float32")
    checkpoint_dir: str = _flag("--checkpoint-dir", default=".")
    num_examples: int = _flag("--num-examples", default=0,
                              help="synthetic dataset size when --dataset synthetic")
    multislice: bool = _flag("--multislice", default=False, action="store_true",
                             help="print the nodes x local-ranks layout (multi-node)")
    export_torch: str = _flag("--export-torch", default="",
                              help="also write a reference-layout .pth.tar "
                                   "checkpoint to this path")
    canvas_cache: str = _flag("--canvas-cache", default="",
                              help="decode-once canvas cache directory for "
                                   "the file readers")
    unroll_fixations: int = _flag("--unroll-fixations", default=0,
                                  help="JAX scan-unroll knob; only 0 is "
                                       "accepted, the eager loop has no "
                                       "scan to unroll")
    device_prefetch: int = _flag("--device-prefetch", default=2,
                                 help="batches copied to the device ahead of "
                                      "the train step (0: each copied when "
                                      "used)")
    stat_fusion: str = _flag("--stat-fusion", default="",
                             choices=["", "gram", "pallas"],
                             help="take the Bottleneck 1x1 convs' BN "
                                  "statistics from the convs: 'pallas' (the "
                                  "conv1x1_stats kernel) or 'gram' (from the "
                                  "conv input); '' for separate BN passes")
    device: str = _flag("--device", default="cuda",
                        help="'cuda' (default; raises if absent) or 'cpu'")


@dataclass
class EvalConfig:
    """``Representation_Evaluation.parse()`` flags, plus the framework
    extensions: the linear-probe driver."""

    model: str = _flag("model", default=None, positional=True,
                       help="path to the pretrained SimCLR checkpoint")
    data: str = _flag("data", default=None, positional=True)
    arch: str = _flag("--arch", "-a", default="ResNet18", choices=MODEL_NAMES)
    # classifier TYPE, not a path (Representation_Evaluation.py:101,427-437)
    classifier: str = _flag("--classifier", default="logistic_regression",
                            choices=["logistic_regression"])
    dataset: str = _flag("--dataset", default="imagenet", choices=DATASETS)
    workers: int = _flag("-j", "--workers", default=4)
    epochs: int = _flag("--epochs", default=90)
    start_epoch: int = _flag("--start-epoch", default=0)
    batch_size: int = _flag("-b", "--batch-size", default=256)
    num_fixations: int = _flag("-f", "--num-fixations", default=2)
    lr: float = _flag("--lr", "--learning-rate", default=1e-7)
    lrs: str = _flag("--lrs", "--learning-rate-scaling", default="linear")
    warmup_epochs: int = _flag("--warmup-epochs", default=10)
    momentum: float = _flag("--momentum", default=0.9)
    weight_decay: float = _flag("--weight-decay", "--wd", default=1e-4)
    print_freq: int = _flag("--print-freq", "-p", default=10)
    resume: str = _flag("--resume", default="")
    optimizer: str = _flag("--optimizer", default="adam", choices=OPTIMIZERS)
    evaluate: bool = _flag("-e", "--evaluate", default=False, action="store_true")
    test: bool = _flag("-t", "--test", default=False, action="store_true")
    verbose: bool = _flag("-v", "--verbose", default=False, action="store_true")
    # --- framework extensions ---
    canvas_size: int = _flag("--canvas-size", default=640)
    seed: int = _flag("--seed", default=15)
    bf16: bool = _flag("--bf16", default=True, action="store_true")
    checkpoint_dir: str = _flag("--checkpoint-dir", default=".")
    num_examples: int = _flag("--num-examples", default=0)
    num_classes: int = _flag("--num-classes", default=1000)
    multislice: bool = _flag("--multislice", default=False, action="store_true",
                             help="print the nodes x local-ranks layout (multi-node)")
    export_torch: str = _flag("--export-torch", default="",
                              help="also write a reference-layout .pth.tar "
                                   "checkpoint to this path")
    canvas_cache: str = _flag("--canvas-cache", default="",
                              help="decode-once canvas cache directory for "
                                   "the file readers")
    device: str = _flag("--device", default="cuda",
                        help="'cuda' (default; raises if absent) or 'cpu'")


@dataclass
class DETRConfig:
    """``DETR_Image_Classification.parse()`` flags, plus the framework
    extensions: the DETR glimpse-sequence classifier driver."""

    backbone_path: str = _flag("backbone_path", default=None, positional=True)
    data: str = _flag("data", default=None, positional=True)
    dataset: str = _flag("--dataset", default="imagenet", choices=DATASETS)
    workers: int = _flag("-j", "--workers", default=4)
    epochs: int = _flag("--epochs", default=2)
    start_epoch: int = _flag("--start-epoch", default=0)
    batch_size: int = _flag("-b", "--batch-size", default=256)
    num_fixations: int = _flag("-f", "--num-fixations", default=2)
    lr: float = _flag("--lr", "--learning-rate", default=1e-4)
    lr_drop: int = _flag("--lr-drop", default=200)
    lr_backbone: float = _flag("--lr_backbone", default=1e-5)
    lrs: str = _flag("--lrs", "--learning-rate-scaling", default="linear")
    warmup_epochs: int = _flag("--warmup-epochs", default=10)
    momentum: float = _flag("--momentum", default=0.9)
    weight_decay: float = _flag("--weight-decay", "--wd", default=1e-4)
    print_freq: int = _flag("--print-freq", "-p", default=10)
    resume: str = _flag("--resume", default="")
    evaluate: bool = _flag("-e", "--evaluate", default=False, action="store_true")
    test: bool = _flag("-t", "--test", default=False, action="store_true")
    verbose: bool = _flag("-v", "--verbose", default=False, action="store_true")
    clip_max_norm: float = _flag("--clip_max_norm", default=0.1)
    backbone: str = _flag("--backbone", default="ResNet18", choices=MODEL_NAMES)
    dilation: bool = _flag("--dilation", default=False, action="store_true")
    position_embedding: str = _flag("--position_embedding", default="sine",
                                    choices=["sine", "learned"])
    enc_layers: int = _flag("--enc_layers", default=6)
    dec_layers: int = _flag("--dec_layers", default=6)
    dim_feedforward: int = _flag("--dim_feedforward", default=2048)
    hidden_dim: int = _flag("--hidden_dim", default=256)
    dropout: float = _flag("--dropout", default=0.1)
    nheads: int = _flag("--nheads", default=8)
    num_queries: int = _flag("--num_queries", default=10)
    pre_norm: bool = _flag("--pre_norm", default=False, action="store_true")
    # --- framework extensions ---
    canvas_size: int = _flag("--canvas-size", default=640)
    seed: int = _flag("--seed", default=15)
    bf16: bool = _flag("--bf16", default=True, action="store_true")
    checkpoint_dir: str = _flag("--checkpoint-dir", default=".")
    num_examples: int = _flag("--num-examples", default=0)
    num_classes: int = _flag("--num-classes", default=1000)
    multislice: bool = _flag("--multislice", default=False, action="store_true",
                             help="print the nodes x local-ranks layout (multi-node)")
    export_torch: str = _flag("--export-torch", default="",
                              help="also write a reference-layout .pth.tar "
                                   "checkpoint to this path")
    canvas_cache: str = _flag("--canvas-cache", default="",
                              help="decode-once canvas cache directory for "
                                   "the file readers")
    backbone_norm: str = _flag("--backbone-norm", default="frozen",
                               choices=["frozen", "group"],
                               help="backbone norm: 'frozen' (FrozenBatchNorm, "
                                    "statistics from the pretrained "
                                    "checkpoint) or 'group' (GroupNorm, for "
                                    "runs from scratch)")
    device: str = _flag("--device", default="cuda",
                        help="'cuda' (default; raises if absent) or 'cpu'")


@dataclass
class RLSConfig(DETRConfig):
    """``DETR_Image_Classification_RLS.parse()`` adds the DQN flags
    (``DETR_Image_Classification_RLS.py:189-218``) to the DETR driver's."""

    dqn_resume: str = _flag("--dqn-resume", default="")
    dqn: str = _flag("--dqn", default="ResNet18", choices=MODEL_NAMES)
    replay_memory_capacity: int = _flag("--replay-memory-capacity", default=10000)
    dqn_batch_size: int = _flag("-dqnb", "--dqn-batch-size", default=256)
    gamma: float = _flag("--gamma", default=0.999)
    eps_start: float = _flag("--eps-start", default=0.9)
    eps_end: float = _flag("--eps-end", default=0.05)
    eps_decay: float = _flag("--eps-decay", default=10.0)
    target_update_freq: int = _flag("--target-update-freq", default=3)
    num_of_actions: int = _flag("--num-of-actions", default=100)
    dense_replay: bool = _flag("--dense-replay", default=False, action="store_true",
                               help="push every consecutive glimpse pair to the "
                                    "replay (the reference pushes only the final "
                                    "pair, RLS :757-769)")


@dataclass
class CaptionProbeConfig:
    """``coco_captions_probe.py``'s flags (the JAX package's caption probe,
    which has no reference CLI), plus ``--device``."""

    model: str = _flag("model", default=None, positional=True,
                       help="pretrained SimCLR checkpoint")
    data: str = _flag("data", default=None, positional=True)
    arch: str = _flag("--arch", "-a", default="ResNet18", choices=MODEL_NAMES)
    dataset: str = _flag("--dataset", default="mscoco",
                         choices=["mscoco", "synthetic", "imagefolder"])
    batch_size: int = _flag("-b", "--batch-size", default=64)
    num_fixations: int = _flag("-f", "--num-fixations", default=2)
    epochs: int = _flag("--epochs", default=5)
    lr: float = _flag("--lr", default=1e-4)
    temperature: float = _flag("--temperature", default=0.05)
    max_len: int = _flag("--max-len", default=32)
    vocab_size: int = _flag("--vocab-size", default=32768)
    print_freq: int = _flag("--print-freq", "-p", default=10)
    workers: int = _flag("-j", "--workers", default=4)
    canvas_size: int = _flag("--canvas-size", default=640)
    seed: int = _flag("--seed", default=15)
    test: bool = _flag("-t", "--test", default=False, action="store_true")
    verbose: bool = _flag("-v", "--verbose", default=False, action="store_true")
    num_examples: int = _flag("--num-examples", default=0)
    checkpoint_dir: str = _flag("--checkpoint-dir", default=".")
    resume: str = _flag("--resume", default="")
    canvas_cache: str = _flag("--canvas-cache", default="",
                              help="decode-once canvas cache directory")
    device: str = _flag("--device", default="cuda",
                        help="'cuda' (default; raises if absent) or 'cpu'")


def check_ported(cfg) -> None:
    """Refuse every flag value of a driver config whose feature is not
    ported yet, naming the ROADMAP item."""
    if getattr(cfg, "unroll_fixations", 0) != 0:
        raise NotImplementedError(
            "--unroll-fixations tunes the JAX scan; the eager fixation loop "
            "has nothing to unroll (leave it at 0)")


def add_args_from_dataclass(parser: argparse.ArgumentParser, cls) -> None:
    for f in fields(cls):
        meta = dict(f.metadata)
        names = meta.pop("names", (f"--{f.name.replace('_', '-')}",))
        positional = meta.pop("positional", False)
        action = meta.pop("action", None)
        kwargs = {"help": meta.get("help")}
        if positional:
            # optional: --dataset synthetic needs no data path
            parser.add_argument(names[0], nargs="?", default=f.default,
                                type=type(f.default) if f.default is not None else str,
                                **kwargs)
        elif action == "store_true":
            parser.add_argument(*names, dest=f.name, action="store_true",
                                default=f.default, **kwargs)
            if f.default:
                # a store_true flag that defaults on needs a --no-X switch
                off = [f"--no-{n[2:]}" for n in names if n.startswith("--")]
                if off:
                    parser.add_argument(*off, dest=f.name,
                                        action="store_false",
                                        help=f"disable {names[0]}")
        else:
            choices = meta.get("choices")
            parser.add_argument(*names, dest=f.name, type=type(f.default),
                                default=f.default, choices=choices, **kwargs)


def parse_into(cls, argv=None, prog: str | None = None):
    parser = argparse.ArgumentParser(prog=prog)
    add_args_from_dataclass(parser, cls)
    ns = parser.parse_args(argv)
    kwargs = {f.name: getattr(ns, f.name) for f in fields(cls)}
    return cls(**kwargs)
