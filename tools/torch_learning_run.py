#!/usr/bin/env python3
"""The JAX package's driver-level learning run, on the port.

Epochs of train → validate → checkpoint through each driver's CLI, over a
JPEG corpus on disk, through the host path (``HostLoader`` → canvas cache
→ the card's retina): the commands of ``tools/tpu_learning_run.sh``,
``tpu_learning_run2.sh``, ``tpu_learning_run3.sh`` and the captions leg of
``tpu_run_queue5.sh``, flag for flag (:data:`LEGS`), run as
``python -m multimodal_active_ai_tpu_torch.<driver>``, one process a leg as
the scripts run them. A leg that reads a pretrained model takes the
``model_best.pth.tar`` of the leg named in its ``model_from``, where the JAX
script took ``model_best.msgpack``.

The corpus is ``tools/make_tiny_imagefolder.py``'s (10 classes × 96 train +
16 val structured JPEGs at 640 px, seed 0: the JAX run's bytes), made by
running that script. The canvas cache lives in a temporary directory under
``/dev/shm`` where that has room (the JAX run moved there after disk-backed
memmap gathers collapsed, ``tpu_learning_run.sh:21-24``), else under the
system's temporary directory.

Each leg's ``##`` lines (``##Contrastive Top-1``, ``##Top-1``/``##Top-5``,
``##Policy Top-1``, ``##I2T``/``##T2I Top-1``) and the loss of its speed
lines are parsed into one JSON summary: per leg the per-epoch numbers (in
percent), the best, the chance line, the seconds, the JAX TPU run's numbers
(:data:`JAX_TPU`) and the card's name and power limit. A leg that exits
non-zero, prints no ``##`` line or stops before its last epoch ends the run
with a non-zero exit. Validation pads its last batch by repeating the last
file, and both packages' top-1s count those rows (160 val images at b=96
are 192 rows), so the port's numbers and the JAX run's are counted alike.

Run it on the card::

    python3 tools/torch_learning_run.py [--legs part1_simclr,part1_probe]
        [--out summary.json] [--log-dir DIR]

``--device cpu --arch ResNet10 --batch 8 --size 64 --classes 2
--per-class 8 --epochs-scale 0`` rehearses the chain on
the CPU (one epoch a leg; ``--size`` is the corpus's side and the drivers'
``--canvas-size``). It imports torch and the port, never JAX or the JAX
package; without ``--device cpu`` it needs a card and stops without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

PACKAGE = chip_smoke.PACKAGE


@dataclass(frozen=True)
class Leg:
    """One JAX command. ``argv`` is its argument list after the script name,
    letter for letter, with the script's path variables as ``{data}``,
    ``{model}``, ``{cache}`` and ``{work}``."""

    name: str
    script: str          # the JAX script and the line its command starts on
    driver: str          # module of the port package
    work: str            # the JAX script's $WORK (lr50, lr18; queue5's own)
    argv: tuple
    model_from: str | None = None
    timeout: int = 5400  # the JAX script's `timeout`, seconds


_PART1 = ("--dataset", "imagenet", "-a", "ResNet50")
_SIMCLR18 = ("{data}", "--dataset", "imagenet", "-a", "ResNet18", "-b", "96", "-f", "2")
_SIMCLR18_RECIPE = ("--optimizer", "adam", "--lr", "0.001", "--warmup-epochs", "2",
                    "--temperature", "0.5", "--color-augmentation", "0",
                    "--gaussian-noise-augmentation", "0", "--canvas-cache", "{cache}",
                    "--checkpoint-dir", "{work}/simclr", "-p", "4")

LEGS = (
    Leg("part1_simclr", "tools/tpu_learning_run.sh:31", "contrastive_learning", "lr50",
        ("{data}",) + _PART1 + ("-b", "96", "-f", "5", "--epochs", "10", "--optimizer", "adam",
                                "--lr", "0.001", "--warmup-epochs", "1", "--canvas-cache",
                                "{cache}", "--checkpoint-dir", "{work}/simclr", "-p", "2")),
    Leg("part1_probe", "tools/tpu_learning_run.sh:41", "representation_evaluation", "lr50",
        ("{model}", "{data}") + _PART1 + ("--num-classes", "10", "-b", "96", "-f", "5",
                                          "--epochs", "15", "--optimizer", "adam", "--lr",
                                          "0.001", "--canvas-cache", "{cache}",
                                          "--checkpoint-dir", "{work}/probe", "-p", "2"),
        model_from="part1_simclr"),
    Leg("part2_detr", "tools/tpu_learning_run2.sh:30", "detr_image_classification", "lr50",
        ("{model}", "{data}", "--dataset", "imagenet", "--backbone", "ResNet50",
         "--num-classes", "10", "-b", "96", "-f", "5", "--epochs", "12", "--canvas-cache",
         "{cache}", "--checkpoint-dir", "{work}/detr", "-p", "2"),
        model_from="part1_simclr"),
    Leg("part2_rls", "tools/tpu_learning_run2.sh:37", "detr_image_classification_rls", "lr50",
        ("{model}", "{data}", "--dataset", "imagenet", "--backbone", "ResNet50",
         "--num-classes", "10", "-b", "96", "-f", "5", "--epochs", "12", "--canvas-cache",
         "{cache}", "--checkpoint-dir", "{work}/rls", "-p", "2"),
        model_from="part1_simclr", timeout=7200),
    Leg("part2_captions", "tools/tpu_learning_run2.sh:48", "coco_captions_probe", "lr50",
        ("{model}", "{data}", "--dataset", "imagefolder", "-a", "ResNet50", "-b", "64", "-f",
         "5", "--epochs", "10", "--canvas-cache", "{cache}", "--checkpoint-dir",
         "{work}/captions", "-p", "2"),
        model_from="part1_simclr"),
    Leg("part3_simclr", "tools/tpu_learning_run3.sh:28", "contrastive_learning", "lr18",
        _SIMCLR18 + ("--epochs", "40") + _SIMCLR18_RECIPE, timeout=9000),
    Leg("part3_probe", "tools/tpu_learning_run3.sh:40", "representation_evaluation", "lr18",
        ("{model}", "{data}", "--dataset", "imagenet", "-a", "ResNet18", "--num-classes", "10",
         "-b", "96", "-f", "2", "--epochs", "15", "--optimizer", "adam", "--lr", "0.001",
         "--canvas-cache", "{cache}", "--checkpoint-dir", "{work}/probe", "-p", "4"),
        model_from="part3_simclr"),
    Leg("queue5_simclr", "tools/tpu_run_queue5.sh:51", "contrastive_learning", "queue5",
        _SIMCLR18 + ("--epochs", "20") + _SIMCLR18_RECIPE, timeout=6000),
    Leg("queue5_captions", "tools/tpu_run_queue5.sh:60", "coco_captions_probe", "queue5",
        ("{model}", "{data}", "--dataset", "imagefolder", "-a", "ResNet18", "-b", "64", "-f",
         "2", "--epochs", "12", "--canvas-cache", "{cache}", "--checkpoint-dir",
         "{work}/captions", "-p", "4"),
        model_from="queue5_simclr"),
)
LEG_BY_NAME = {leg.name: leg for leg in LEGS}

# What each driver prints once an epoch: (summary key, line prefix, factor
# to percent); the first is the leg's headline metric.
METRICS = {
    "contrastive_learning": (("contrastive_top1", "##Contrastive Top-1", 100.0),),
    "representation_evaluation": (("top1", "##Top-1", 1.0), ("top5", "##Top-5", 1.0)),
    "detr_image_classification": (("top1", "##Top-1", 1.0),),
    "detr_image_classification_rls": (("top1", "##Top-1", 1.0),
                                      ("policy_top1", "##Policy Top-1", 1.0)),
    "coco_captions_probe": (("i2t_top1", "##I2T Top-1", 100.0),
                            ("t2i_top1", "##T2I Top-1", 100.0)),
}

# The JAX package's run on the TPU (one seed each; PARITY.md:118-235 and the
# queue5 log, bench_logs_r04_part3.txt), in percent: per-epoch numbers from
# the first epoch where recorded, and the best. part2_captions has none: the
# recorded run read synthetic captions, unlearnable by construction.
JAX_TPU = {
    "part1_simclr": {"contrastive_top1": {"best": 2.08}, "loss": [10.5069, 10.504]},
    "part1_probe": {"top1": {"epochs": [11.98, 24.48, 41.67], "best": 54.17},
                    "top5": {"best": 88.02}},
    "part2_detr": {"top1": {"epochs": [40.63, 55.73, 65.10], "best": 67.71}},
    "part2_rls": {"top1": {"epochs": [26.04], "best": 61.98},
                  "policy_top1": {"epochs": [22.40, 39.58, 45.31], "best": 62.50},
                  "dqn_loss": [404.0, 30.0]},
    "part2_captions": {},
    "part3_simclr": {"contrastive_top1": {"best": 6.77}, "loss": [10.537, 9.96]},
    "part3_probe": {"top1": {"epochs": [9.38, 14.06, 25.52, 43.75, 55.73], "best": 77.08},
                    "top5": {"best": 94.79}},
    "queue5_simclr": {"contrastive_top1": {
        "epochs": [5.7292, 2.6042, 4.6875, 5.7292, 5.2083, 3.125, 4.1667, 4.1667, 3.125,
                   5.2083, 1.0417, 2.0833, 1.5625, 2.6042, 4.6875, 3.125, 1.5625, 2.6042,
                   4.6875, 4.1667], "best": 5.7292}},
    "queue5_captions": {
        "i2t_top1": {"epochs": [3.6458, 5.0, 6.875, 7.1875, 5.9375, 8.5417, 10.5208,
                                11.3542, 14.0625, 14.375, 14.375, 13.9583], "best": 14.375},
        "t2i_top1": {"epochs": [3.8542, 4.2708, 4.8958, 7.5, 9.7917, 10.7292, 12.7083,
                                12.7083, 14.6875, 15.1042, 15.1042, 15.9375],
                     "best": 15.9375}},
}

# the corpus of the JAX run: make_tiny_imagefolder.py's arguments
CORPUS = {"classes": 10, "per_class": 96, "val_per_class": 16, "size": 640, "seed": 0}
SPEED_LINE = re.compile(r"^Epoch: \[(\d+)\]\[\d+/\d+\].*?\tLoss \S+ \((\S+)\)(.*)$", re.M)


def flag_value(argv, *names: str) -> str | None:
    """The value after the first of ``names`` in ``argv``, else None."""
    for i, a in enumerate(argv[:-1]):
        if a in names:
            return argv[i + 1]
    return None


def model_path(leg: Leg, work: str) -> str | None:
    """The ``model_best.pth.tar`` the leg reads: its ``model_from`` leg's."""
    if leg.model_from is None:
        return None
    return os.path.join(work, LEG_BY_NAME[leg.model_from].work, "simclr", "model_best.pth.tar")


def leg_argv(leg: Leg, data: str, work: str, cache: str, device: str = "cuda",
             epochs: int | None = None, arch: str | None = None, batch: int | None = None,
             canvas: int | None = None) -> list[str]:
    """The leg's command line for the port: its JAX arguments with the paths
    filled in (``{work}`` is ``work/<leg.work>``), ``--epochs``, ``-a`` /
    ``--backbone`` and ``-b`` replaced where given, ``--canvas-size`` added
    when ``canvas`` is given, and ``--device``."""
    fill = {"data": data, "cache": cache, "work": os.path.join(work, leg.work),
            "model": model_path(leg, work)}
    out = [a.format(**fill) for a in leg.argv]
    for names, value in ((("--epochs",), epochs), (("-a", "--backbone"), arch),
                         (("-b",), batch)):
        if value is not None:
            i = next(i for i, a in enumerate(out) if a in names)
            out[i + 1] = str(value)
    if canvas is not None:
        out += ["--canvas-size", str(canvas)]
    return out + ["--device", device]


def chance(leg: Leg, argv: list[str]) -> float:
    """The headline metric's chance line in percent: 1/(2b−1) for the
    contrastive top-1 (the positive among the other 2b−1 views), 1/b for
    caption retrieval, 1/classes for a classifier."""
    b = int(flag_value(argv, "-b"))
    if leg.driver == "contrastive_learning":
        return 100.0 / (2 * b - 1)
    if leg.driver == "coco_captions_probe":
        return 100.0 / b
    return 100.0 / int(flag_value(argv, "--num-classes"))


def parse_log(driver: str, log: str) -> dict:
    """A driver run's per-epoch numbers: each :data:`METRICS` line in
    percent, the mean train loss of the epoch's last speed line and, for
    RLS, its DQN loss."""
    out = {key: [float(v) * scale for v in re.findall(rf"^{re.escape(prefix)} (\S+)$", log,
                                                        re.M)]
           for key, prefix, scale in METRICS[driver]}
    loss, dqn = {}, {}
    for epoch, avg, rest in SPEED_LINE.findall(log):
        loss[int(epoch)] = float(avg)
        m = re.search(r"DQN-Loss (\S+)", rest)
        if m:
            dqn[int(epoch)] = float(m.group(1))
    out["loss"] = [loss[e] for e in sorted(loss)]
    if driver == "detr_image_classification_rls":
        out["dqn_loss"] = [dqn[e] for e in sorted(dqn)]
    return out


def leg_summary(leg: Leg, argv: list[str], log: str, seconds: float, rc: int) -> dict:
    """The summary of one leg; ``problem`` is set when the leg failed: a
    non-zero exit, no ``##`` line, or fewer epochs of numbers than
    ``--epochs``."""
    nums = parse_log(leg.driver, log)
    epochs = int(flag_value(argv, "--epochs"))
    keys = [key for key, _, _ in METRICS[leg.driver]]
    out = {"name": leg.name, "jax_command": leg.script, "driver": f"{PACKAGE}.{leg.driver}",
           "argv": argv, "epochs": epochs, "seconds": seconds, "rc": rc,
           "chance": chance(leg, argv), "metrics": {k: nums[k] for k in keys},
           "best": {k: max(nums[k]) if nums[k] else None for k in keys},
           "loss": nums["loss"], "jax_tpu": JAX_TPU[leg.name]}
    if "dqn_loss" in nums:
        out["dqn_loss"] = nums["dqn_loss"]
    if rc != 0:
        out["problem"] = f"exit code {rc}"
    elif not nums[keys[0]]:
        out["problem"] = "no ## line"
    elif any(len(nums[k]) != epochs for k in keys):
        out["problem"] = (f"{[len(nums[k]) for k in keys]} epochs of numbers, "
                          f"expected {epochs}")
    return out


def make_corpus(out: str, classes: int, per_class: int, val_per_class: int, size: int,
                seed: int = 0, cue: str = "none") -> str:
    """``tools/make_tiny_imagefolder.py OUT ...`` run as a script (it imports
    numpy and PIL only); returns ``out``."""
    cmd = [sys.executable, os.path.join(ROOT, "tools", "make_tiny_imagefolder.py"), out,
           "--classes", str(classes), "--per-class", str(per_class),
           "--val-per-class", str(val_per_class), "--size", str(size), "--seed", str(seed),
           "--cue", cue]
    subprocess.run(cmd, check=True, stdout=subprocess.DEVNULL)
    return out


def cache_parent(nbytes: int) -> str:
    """``/dev/shm`` where it exists and has twice ``nbytes`` free, else the
    system's temporary directory."""
    shm = "/dev/shm"
    if os.path.isdir(shm) and shutil.disk_usage(shm).free >= 2 * nbytes:
        return shm
    return tempfile.gettempdir()


def run_leg(leg: Leg, argv: list[str], log_dir: str | None) -> tuple[str, float, int]:
    """``python -m <package>.<driver> argv`` from the repository root; its
    output (also written to ``log_dir/<leg>.log``), seconds and exit code."""
    cmd = [sys.executable, "-m", f"{PACKAGE}.{leg.driver}", *argv]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True, timeout=leg.timeout)
        log, rc = p.stdout, p.returncode
    except subprocess.TimeoutExpired as e:
        out = e.stdout or ""
        log, rc = out.decode() if isinstance(out, bytes) else out, 124
    seconds = time.perf_counter() - t0
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, f"{leg.name}.log"), "w") as f:
            f.write(" ".join(cmd) + "\n" + log)
    return log, seconds, rc


def print_leg(s: dict) -> None:
    """One leg's numbers beside the JAX run's."""
    for key, values in s["metrics"].items():
        jax = s["jax_tpu"].get(key, {})
        print(f"{s['name']} {key} (%) per epoch {[round(v, 2) for v in values]}, best "
              f"{s['best'][key]}; JAX TPU per epoch {jax.get('epochs', '-')}, best "
              f"{jax.get('best', '-')}; chance {s['chance']:.2f}")
    print(f"{s['name']} loss per epoch {[round(v, 4) for v in s['loss']]}"
          + (f", DQN loss {[round(v, 2) for v in s['dqn_loss']]}" if "dqn_loss" in s else "")
          + f"; {s['seconds']:.1f} s" + (f"; FAILED: {s['problem']}" if "problem" in s else ""),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--legs", default=",".join(leg.name for leg in LEGS),
                    help="comma-separated legs to run, in the order given")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--epochs-scale", type=float, default=1.0,
                    help="each leg's --epochs times this, at least 1")
    ap.add_argument("--arch", default=None, help="replaces -a/--backbone (rehearsals)")
    ap.add_argument("--batch", type=int, default=None, help="replaces -b (rehearsals)")
    ap.add_argument("--size", type=int, default=CORPUS["size"],
                    help="the corpus's side and, when not 640, the drivers' --canvas-size")
    ap.add_argument("--classes", type=int, default=CORPUS["classes"])
    ap.add_argument("--per-class", type=int, default=CORPUS["per_class"],
                    help="train images a class (the val split keeps its 16)")
    ap.add_argument("--work", default=None, help="directory for the corpus and checkpoints "
                                                 "(default: a temporary one, removed)")
    ap.add_argument("--out", default=None, help="write the JSON summary here too")
    ap.add_argument("--log-dir", default=None, help="write each leg's output here")
    args = ap.parse_args(argv)
    names = args.legs.split(",")
    unknown = [n for n in names if n not in LEG_BY_NAME]
    if unknown:
        ap.error(f"unknown legs {unknown}; the legs are {[leg.name for leg in LEGS]}")
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("torch_learning_run: CUDA is not available (use --device cpu to rehearse "
                  "on the CPU)", file=sys.stderr)
            return 1
    card = "cpu" if args.device == "cpu" else chip_smoke.gpu_name_and_power()
    print(f"card: {card}", flush=True)

    work = args.work or tempfile.mkdtemp(prefix="torch_learning_run_")
    val_per_class = CORPUS["val_per_class"]
    images = args.classes * (args.per_class + val_per_class)
    cache = tempfile.mkdtemp(prefix="torch_learning_run_cache_",
                             dir=cache_parent(images * args.size ** 2 * 3))
    summary = {"card": card, "device": args.device, "corpus": {
        "classes": args.classes, "per_class": args.per_class,
        "val_per_class": val_per_class, "size": args.size, "seed": CORPUS["seed"]},
        "cache": cache, "legs": []}
    try:
        t0 = time.perf_counter()
        data = make_corpus(os.path.join(work, "tiny10"), args.classes, args.per_class,
                           val_per_class, args.size, CORPUS["seed"])
        summary["corpus"]["seconds"] = time.perf_counter() - t0
        print(f"corpus: {images} JPEGs at {args.size} px in "
              f"{summary['corpus']['seconds']:.1f} s; canvas cache in {cache}", flush=True)
        for name in names:
            leg = LEG_BY_NAME[name]
            epochs = int(flag_value(leg.argv, "--epochs"))
            argv_ = leg_argv(leg, data, work, cache, args.device,
                             epochs=max(1, round(epochs * args.epochs_scale)), arch=args.arch,
                             batch=args.batch,
                             canvas=args.size if args.size != CORPUS["size"] else None)
            model = model_path(leg, work)
            if model and not os.path.isfile(model):
                summary["legs"].append({"name": name, "problem": f"no {model}"})
                print(f"{name}: FAILED: {leg.model_from} wrote no {model}", flush=True)
                break
            print(f"=== {name} ({leg.script}): python -m {PACKAGE}.{leg.driver} "
                  f"{' '.join(argv_)}", flush=True)
            log, seconds, rc = run_leg(leg, argv_, args.log_dir)
            s = leg_summary(leg, argv_, log, seconds, rc)
            s["card"] = card
            summary["legs"].append(s)
            print_leg(s)
            if "problem" in s:
                print(log[-4000:], flush=True)
                break
    finally:
        shutil.rmtree(cache, ignore_errors=True)
        if args.work is None:
            shutil.rmtree(work, ignore_errors=True)
    text = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    failed = [s["name"] for s in summary["legs"] if "problem" in s]
    ran = len(summary["legs"])
    if failed or ran != len(names):
        print(f"torch_learning_run: FAILED: {failed or names[ran:]}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
