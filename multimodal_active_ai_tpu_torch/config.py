"""SimCLR driver config and the argparse shim that builds its CLI.

The port's own copy of ``multimodal_active_ai_tpu/config.py``
(``ContrastiveConfig``, ``add_args_from_dataclass``, ``parse_into``): the
same flag names and defaults, so a JAX command line runs here unchanged,
plus ``--device``. Flags whose feature has not been ported raise
``NotImplementedError`` in ``contrastive_learning``, naming the ROADMAP item. The file
readers' own flags (``-j``, ``--device-prefetch``) have no effect with
``--dataset synthetic``, as in the JAX driver.
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
                             help="multi-host mesh (not ported: raises)")
    export_torch: str = _flag("--export-torch", default="",
                              help="also write a reference-layout .pth.tar "
                                   "checkpoint to this path")
    canvas_cache: str = _flag("--canvas-cache", default="",
                              help="decode-once canvas cache directory for "
                                   "the file readers (not ported: raises)")
    unroll_fixations: int = _flag("--unroll-fixations", default=0,
                                  help="JAX scan-unroll knob; only 0 is "
                                       "accepted, the eager loop has no "
                                       "scan to unroll")
    device_prefetch: int = _flag("--device-prefetch", default=2,
                                 help="host->device prefetch depth of the "
                                      "file readers; synthetic batches are "
                                      "made on the device")
    stat_fusion: str = _flag("--stat-fusion", default="",
                             choices=["", "gram", "pallas"],
                             help="take the Bottleneck 1x1 convs' BN "
                                  "statistics from the convs: 'pallas' (the "
                                  "conv1x1_stats kernel) or 'gram' (from the "
                                  "conv input); '' for separate BN passes")
    device: str = _flag("--device", default="cuda",
                        help="'cuda' (default; raises if absent) or 'cpu'")


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
