"""Throughput of the port's training and inference paths, in images/sec/chip.

Port of the repository root's ``bench.py``: the same modes, knobs,
configurations, units and JSON record, run on the port's step functions::

    python -m multimodal_active_ai_tpu_torch.bench            # SimCLR train, on the card
    BENCH_MODE=detr python -m multimodal_active_ai_tpu_torch.bench
    BENCH_DEVICE=cpu BENCH_MODE=rls python -m multimodal_active_ai_tpu_torch.bench

``BENCH_MODE`` (one "image" in brackets):

* unset: SimCLR-with-saccades train step (one aug+fwd+bwd view: ``F`` a
  source image), ``BENCH_ARCH`` (ResNet50 on the card, ResNet18 on the
  CPU), ``BENCH_FIXATIONS`` (10 / 2), ``BENCH_NORM`` (``bn`` |
  ``bn_fused``), ``BENCH_STATS`` (``gram`` | ``pallas``), ``BENCH_OPT``
  (adam), ``BENCH_ADAM_MU`` (e.g. ``bfloat16``: Adam's first moment in
  that dtype); ``BENCH_INPUT=host`` (or ``--input=host``) feeds it JPEG
  files through the host loader instead of batches made on the device;
* ``detr``: DETR classifier inference (a classified source image);
* ``probe``: linear-probe train step (a source image);
* ``rls``: RLS rollout + DETR update + a DQN update on every step (a
  source image);
* ``captions``: caption-probe train step (an image–caption pair).

Shared knobs: ``BENCH_DEVICE`` (``cuda`` unless ``cpu``; no fallback),
``BENCH_BATCH`` (per chip: 128 on the card, 4 on the CPU),
``BENCH_CANVAS`` (640 / 64), ``BENCH_STEPS`` (10 / 2), ``BENCH_WINDOWS``
(3), ``BENCH_VERBOSE``. ``BENCH_TRACE=<dir>`` traces the first timing
window into ``<dir>/trace.json`` and prints the device busy ms a step and
the window's busy share; ``BENCH_MFU=1`` (SimCLR) counts one step's FLOPs
and prints the share of ``BENCH_PEAK_TFLOPS`` (989: H100 SXM bf16 dense)
it reached. Host input: ``BENCH_SRC`` (source JPEG side, 640),
``BENCH_WORKERS``, ``BENCH_PREFETCH``, ``BENCH_CACHE`` (a decode-once
canvas cache; one warm epoch untimed), ``BENCH_DEV_PREFETCH`` (2).

Each run prints one JSON line: ``metric``, ``value`` (the best window),
``unit``, ``windows_img_s_chip`` and ``median_img_s_chip`` (device input),
``config`` (the downstream modes), ``norm`` and ``adam_mu_dtype`` (SimCLR,
where set), as the JAX bench writes them; and, unlike it, ``device`` (the
card's name, the device count and its power limit, or ``{"name": "cpu"}``)
and ``launches`` (the port's kernel launches in the timed windows). It has
no ``vs_baseline``: that ratio is to a TPU target.

Under a launcher's ``WORLD_SIZE``/``RANK`` (or ``MAAI_NUM_PROCESSES``)
each rank runs ``BENCH_BATCH`` rows of the global batch, rank 0 prints,
and the rates are per chip.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from contextlib import closing
from time import perf_counter
from typing import Callable, Mapping, NamedTuple

import torch

from multimodal_active_ai_tpu_torch import parallel
from multimodal_active_ai_tpu_torch.config import DETRConfig, EvalConfig, RLSConfig
from multimodal_active_ai_tpu_torch.device import synchronize
from multimodal_active_ai_tpu_torch.models import detr as detr_models
from multimodal_active_ai_tpu_torch.models.mlp import LogisticRegression
from multimodal_active_ai_tpu_torch.models.norm import refuse_multi_device
from multimodal_active_ai_tpu_torch.models.qnet import build_dqn
from multimodal_active_ai_tpu_torch.models.resnet import encoder_feature_dim
from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
from multimodal_active_ai_tpu_torch.models.text import TextEncoder
from multimodal_active_ai_tpu_torch.ops import conv1x1_stats, glimpse_sample, retina, stat_sums
from multimodal_active_ai_tpu_torch.train import (caption_probe, detr_train, eval_probe,
                                                  optimizers, rls_train, schedule, simclr_train)
from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState
from multimodal_active_ai_tpu_torch.utils import profiling

KERNELS = {"glimpse_sample": glimpse_sample.glimpse_sample, "stat_sums": stat_sums.stat_sums,
           "conv1x1_stats": conv1x1_stats.conv1x1_stats, "hat_sample": glimpse_sample.hat_sample}
# knobs of the JAX bench that tune what XLA compiles; eager PyTorch has
# none of these, so they are read and ignored
JAX_ONLY = {"BENCH_UNROLL": "no lax.scan to unroll (the fixation loop is eager Python)",
            "BENCH_NO_DONATE": "no buffer donation (eager steps update in place)",
            "BENCH_FORCE_MESH": "no jit mesh (one process per card)"}
# NVIDIA H100 SXM data sheet, bf16 dense tensor-core peak
H100_BF16_TFLOPS = 989.0


def _jpeg_corpus(n_images: int, src: int, tmp_root: str | None = None) -> list[str]:
    """A cached corpus of ``n_images`` distinct ``src``-pixel JPEGs made from
    seed 0 (the JAX bench's ``_jpeg_corpus``: smooth gradients plus noise,
    closer to a photo's entropy than noise alone), in the temporary
    directory."""
    import numpy as np
    from PIL import Image

    root = os.path.join(tmp_root or tempfile.gettempdir(), f"maai_bench_jpegs_{src}px_{n_images}")
    os.makedirs(root, exist_ok=True)
    paths = [os.path.join(root, f"{i:05d}.jpg") for i in range(n_images)]
    missing = [(i, p) for i, p in enumerate(paths) if not os.path.isfile(p)]
    if missing:
        base = np.random.RandomState(0).randint(0, 256, (16, 16, 3), np.uint8)

        def make(args):
            i, p = args
            r = np.random.RandomState(i)
            im = np.asarray(Image.fromarray(base).resize((src, src), Image.BILINEAR))
            im = np.clip(im.astype(np.int16) + r.randint(-24, 24, im.shape, np.int16),
                         0, 255).astype(np.uint8)
            # written whole, then renamed: an interrupted run leaves no
            # truncated JPEG for the isfile() check to trust
            Image.fromarray(im).save(p + ".tmp", format="JPEG", quality=90)
            os.replace(p + ".tmp", p)

        with ThreadPoolExecutor(max_workers=os.cpu_count() or 8) as pool:
            list(pool.map(make, missing))
    return paths


def _window_rates(window_dts, units: float, n_dev: int):
    """(sorted per-chip rates, median) from per-window wall times."""
    rates = sorted(units / d / n_dev for d in window_dts)
    k = len(rates)
    median = rates[k // 2] if k % 2 else 0.5 * (rates[k // 2 - 1] + rates[k // 2])
    return rates, median


def _device_info(device: torch.device) -> dict:
    """The card's name, the device count and the power limit ``nvidia-smi``
    reports (a card set below its maximum runs slower), or the CPU."""
    if device.type != "cuda":
        return {"name": "cpu"}
    out = subprocess.run(["nvidia-smi", f"--id={device.index or 0}",
                          "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return {"name": torch.cuda.get_device_name(device), "count": torch.cuda.device_count(),
            "power_limit": out.stdout.strip().rsplit(", ", 1)[-1]}


class _Env:
    """The knobs, the device, the ranks and the per-device defaults every
    mode shares (the JAX bench's ``_bench_env``, with ``on_tpu`` read as
    "on the card")."""

    def __init__(self, knobs: Mapping[str, str], device: torch.device):
        self.knobs = knobs
        self.device = device
        self.on_card = device.type == "cuda"
        self.world = parallel.world_size()
        self.batch = self.knob_int("BENCH_BATCH", 128, 4)       # per chip
        self.canvas = self.knob_int("BENCH_CANVAS", 640, 64)
        self.steps = self.knob_int("BENCH_STEPS", 10, 2)
        self.windows = int(knobs.get("BENCH_WINDOWS", "3"))
        if self.windows < 1:
            raise ValueError(f"BENCH_WINDOWS must be >= 1, got {self.windows}")
        self.global_batch = self.batch * self.world
        self.retina_cfg = (retina.RetinaConfig(canvas_size=self.canvas) if self.canvas >= 640
                           else retina.RetinaConfig(canvas_size=self.canvas,
                                                    crop_sizes=(40, 24, 10, 30), supersample=2))
        # the images (and labels or tokens) are drawn once; each step draws
        # its augmentations from a generator reseeded with the step's index,
        # so no two steps see the same draws
        self._gen = torch.Generator(device).manual_seed(0)
        self._step_gens = [torch.Generator(device) for _ in range(2)]
        self._host_gen = torch.Generator()

    def knob_int(self, key: str, on_card: int, on_cpu: int) -> int:
        return int(self.knobs.get(key, str(on_card if self.on_card else on_cpu)))

    def knob_str(self, key: str, on_card: str, on_cpu: str) -> str:
        return self.knobs.get(key, on_card if self.on_card else on_cpu)

    def images(self) -> torch.Tensor:
        """This rank's rows of a global batch of uint8 canvases."""
        g = self.global_batch
        return parallel.local_rows(torch.randint(
            0, 256, (g, self.canvas, self.canvas, 3), generator=self._gen,
            device=self.device, dtype=torch.uint8))

    def ints(self, high: int, *shape: int) -> torch.Tensor:
        """This rank's rows of ``(global batch, *shape)`` integers in [0, high)."""
        return parallel.local_rows(torch.randint(0, high, (self.global_batch, *shape),
                                                 generator=self._gen, device=self.device))

    def step_generators(self, i: int) -> tuple[torch.Generator, torch.Generator, torch.Generator]:
        """Step ``i``'s device generators (draws, dropout) and host generator."""
        for k, g in enumerate(self._step_gens):
            g.manual_seed(1 + 2 * i + k)
        self._host_gen.manual_seed(1 + i)
        return (*self._step_gens, self._host_gen)

    def place(self, model: torch.nn.Module) -> torch.nn.Module:
        model = model.to(self.device)
        return model.to(memory_format=torch.channels_last) if self.on_card else model


class _Mode(NamedTuple):
    metric: str
    run_one: Callable[..., object]     # step i (SimCLR: and its batch); the step's result
    units: int                         # images a step, global
    labels: dict                       # the record's keys after the rates


def _seeded(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _detr(env: _Env) -> _Mode:
    """DETR classifier inference (BASELINE.md target 3): the labeled retina
    at F random saccades, the frozen-BN backbone, the transformer, the
    query-mean logits; the model at init in eval mode, no optimizer."""
    fixations = int(env.knobs.get("BENCH_FIXATIONS", "2"))
    cfg = DETRConfig(backbone=env.knobs.get("BENCH_ARCH", "ResNet18"), dataset="imagenet")
    model, criterion = detr_models.build(cfg, num_classes=1000, dtype=torch.bfloat16,
                                         generator=_seeded(0))
    state = TrainState(env.place(model), optimizer=None, schedule=None)
    step = detr_train.make_detr_eval_step(criterion, env.retina_cfg, fixations)
    images, labels = env.images(), env.ints(1000)

    def run_one(i):
        return step(state, images, labels, env.step_generators(i)[0])

    return _Mode("detr_classifier_inference_images_per_sec_per_chip", run_one,
                 env.global_batch,
                 {"config": {"backbone": cfg.backbone, "fixations": fixations,
                             "batch": env.global_batch, "canvas": env.canvas,
                             "num_queries": cfg.num_queries, "enc_layers": cfg.enc_layers,
                             "dec_layers": cfg.dec_layers}})


def _encoder(arch: str, env: _Env) -> SimCLRModule:
    """A frozen bf16 SimCLR encoder at init, in eval mode."""
    return env.place(SimCLRModule(arch=arch, norm_kind="bn", dtype=torch.bfloat16,
                                  generator=_seeded(0))).eval()


def _probe(env: _Env) -> _Mode:
    """Linear-probe train step: frozen-encoder features of F labeled
    glimpses and the probe's Adam update."""
    cfg = EvalConfig(arch=env.knobs.get("BENCH_ARCH", "ResNet18"))
    fixations = int(env.knobs.get("BENCH_FIXATIONS", str(cfg.num_fixations)))
    enc = _encoder(cfg.arch, env)
    probe = env.place(LogisticRegression(encoder_feature_dim(cfg.arch) * 16 * fixations,
                                         cfg.num_classes, generator=_seeded(1)))
    state = TrainState(probe, optimizers.get_optimizer("adam", probe.parameters()),
                       lambda _: cfg.lr)
    step = eval_probe.make_probe_train_step(env.retina_cfg, fixations)
    images, labels = env.images(), env.ints(cfg.num_classes)

    def run_one(i):
        return step(state, enc, images, labels, env.step_generators(i)[0])

    return _Mode("probe_train_images_per_sec_per_chip", run_one, env.global_batch,
                 {"config": {"arch": cfg.arch, "fixations": fixations,
                             "batch": env.global_batch, "canvas": env.canvas,
                             "num_classes": cfg.num_classes}})


def _rls(env: _Env) -> _Mode:
    """RLS train step: the ε-greedy rollout (the policy's argmax at the
    non-random fixations of epoch 1), the DETR update, and a Bellman DQN
    update on every step on a zero transition batch of the global batch's
    rows (the driver flips a 0.7 coin; the bench times the full-cost
    step, and says so in its config)."""
    fixations = int(env.knobs.get("BENCH_FIXATIONS", "4"))
    cfg = RLSConfig(backbone=env.knobs.get("BENCH_ARCH", "ResNet18"), dataset="imagenet",
                    num_fixations=fixations)
    model, criterion = detr_models.build(cfg, num_classes=1000, dtype=torch.bfloat16,
                                         generator=_seeded(0))
    model = env.place(model)
    state = TrainState(model, detr_train.make_detr_optimizer(
        model, cfg.lr, cfg.lr_backbone, cfg.weight_decay), detr_train.step_lr(1000, cfg.lr_drop))
    # sync_bn on several ranks: the statistics of the global replay batch
    dqn = env.place(build_dqn(cfg.dqn, cfg.num_of_actions,
                              norm_kind="sync_bn" if env.world > 1 else "bn",
                              dtype=torch.bfloat16, generator=_seeded(1)))
    target = copy.deepcopy(dqn)
    pstate = TrainState(dqn, optimizers.get_optimizer("rmsprop", dqn.parameters()),
                        lambda _: cfg.lr)
    tstep = rls_train.make_rls_train_step(criterion, env.retina_cfg, fixations,
                                          cfg.num_of_actions, cfg.eps_start, cfg.eps_end,
                                          cfg.eps_decay, cfg.clip_max_norm)
    dqn_update = rls_train.make_dqn_update_step(cfg.num_of_actions, cfg.gamma)
    images, labels = env.images(), env.ints(1000)
    g, c = env.retina_cfg.glimpse_size, env.retina_cfg.num_channels
    zeros = lambda *shape: torch.zeros((env.batch, *shape), device=env.device)  # noqa: E731
    transition = (zeros(g, g, c), zeros(2), zeros(g, g, c), zeros())

    def run_one(i):
        gen, drop, host = env.step_generators(i)
        draws = rls_train.draw_rollout(gen, host, env.batch, fixations, drop)
        tstep(state, dqn, images, labels, 1, draws)
        return dqn_update(pstate, target, transition)

    return _Mode("rls_train_images_per_sec_per_chip", run_one, env.global_batch,
                 {"config": {"backbone": cfg.backbone, "dqn": cfg.dqn, "fixations": fixations,
                             "batch": env.global_batch, "canvas": env.canvas,
                             "num_of_actions": cfg.num_of_actions,
                             "dqn_update_every_step": True, "dqn_batch": env.global_batch,
                             "enc_layers": cfg.enc_layers, "dec_layers": cfg.dec_layers}})


def _captions(env: _Env) -> _Mode:
    """Caption-probe train step: frozen-encoder glimpse features, the image
    head and the text tower, symmetric InfoNCE, one Adam update."""
    arch = env.knobs.get("BENCH_ARCH", "ResNet18")
    fixations = int(env.knobs.get("BENCH_FIXATIONS", "2"))
    max_len, vocab_size, lr, temperature = 32, 32768, 1e-4, 0.05
    enc = _encoder(arch, env)
    towers = env.place(caption_probe.CaptionTowers(
        encoder_feature_dim(arch) * 16 * fixations,
        TextEncoder(vocab_size=vocab_size, out_dim=128, generator=_seeded(2)),
        hidden_dim=1024, out_dim=128, generator=_seeded(1)))
    state = TrainState(towers, optimizers.get_optimizer("adam", towers.parameters()),
                       lambda _: lr)
    step = caption_probe.make_caption_probe_train_step(env.retina_cfg, fixations, temperature)
    images, tokens = env.images(), env.ints(vocab_size, max_len)

    def run_one(i):
        gen, drop, _ = env.step_generators(i)
        return step(state, enc, images, tokens, gen, dropout_generator=drop)

    return _Mode("caption_probe_train_images_per_sec_per_chip", run_one, env.global_batch,
                 {"config": {"arch": arch, "fixations": fixations, "batch": env.global_batch,
                             "canvas": env.canvas, "max_len": max_len,
                             "vocab_size": vocab_size}})


def _simclr(env: _Env, host: bool):
    """The flagship SimCLR train step: 1 + F retina views, F NT-Xent
    forward/backward passes and Adam updates. Its ``run_one(i, batch)``
    takes the images (host input, the MFU count) or uses the device's."""
    fixations = env.knob_int("BENCH_FIXATIONS", 10, 2)
    arch = env.knob_str("BENCH_ARCH", "ResNet50", "ResNet18")
    norm_kind = env.knobs.get("BENCH_NORM", "bn")
    stat_fusion = env.knobs.get("BENCH_STATS") or None
    if stat_fusion == "pallas":
        refuse_multi_device("BENCH_STATS=pallas", "BENCH_STATS=gram")
    adam_mu = env.knobs.get("BENCH_ADAM_MU") or None
    mu_dtype = getattr(torch, adam_mu) if adam_mu else None
    if mu_dtype is not None and not isinstance(mu_dtype, torch.dtype):
        raise ValueError(f"BENCH_ADAM_MU={adam_mu} is not a torch dtype")
    # several ranks: sync_bn is the global batch's statistics, as plain
    # BatchNorm under GSPMD
    model = env.place(SimCLRModule(
        arch=arch, norm_kind="sync_bn" if env.world > 1 and norm_kind == "bn" else norm_kind,
        dtype=torch.bfloat16, stat_fusion=stat_fusion, generator=_seeded(0)))
    sched = schedule.simclr_learning_rate(0.01, env.global_batch, 1_281_167, env.batch, 10, 190)
    opt = optimizers.get_optimizer(env.knobs.get("BENCH_OPT", "adam"), model.parameters(),
                                   mu_dtype=mu_dtype)
    state = TrainState(model, opt, sched)
    step = simclr_train.make_train_step(env.retina_cfg, fixations, 0.05)
    if host:
        metric = f"simclr_{arch.lower()}_e2e_host_images_per_sec_per_chip"
    else:
        metric = f"simclr_{arch.lower()}_aug_fwd_bwd_images_per_sec_per_chip"
    labels = {}
    if norm_kind != "bn" or stat_fusion:
        labels["norm"] = {"kind": norm_kind, "stat_fusion": stat_fusion}
    if adam_mu:
        labels["adam_mu_dtype"] = adam_mu
    images = None if host else env.images()

    def run_one(i, batch=None):
        return step(state, images if batch is None else batch, env.step_generators(i)[0])

    return _Mode(metric, run_one, fixations * env.global_batch, labels)


def _counts() -> dict:
    return {k: f.launches for k, f in KERNELS.items()}


def _since(before: dict) -> dict:
    """The launches since ``before`` (the counters are left as they are:
    a caller may be counting a whole run)."""
    return {k: n - before[k] for k, n in _counts().items()}


def _timed_windows(env: _Env, mode: _Mode, trace_dir: str | None, device_name: str):
    """One warm-up step, then ``BENCH_WINDOWS`` windows of ``BENCH_STEPS``
    steps, each ending in a device synchronise. Returns the windows' wall
    seconds and the kernel launches of the windows. ``trace_dir``: window
    1 under ``utils/profiling.trace``, its device busy time printed."""
    mode.run_one(0)
    synchronize(env.device)
    before = _counts()
    dts, i, busy_ms = [], 1, None
    for w in range(env.windows):
        with profiling.trace(trace_dir, enabled=bool(trace_dir) and w == 0) as prof:
            t0 = perf_counter()
            for _ in range(env.steps):
                mode.run_one(i)
                i += 1
            synchronize(env.device)
            dts.append(perf_counter() - t0)
        if prof is not None:
            busy_ms = sum(us for _, us in profiling.device_leaf_ops(prof)) / 1e3
    if trace_dir:
        _print_busy(busy_ms, os.path.join(trace_dir, "trace.json"), dts, env.steps, device_name)
    return dts, _since(before)


def _print_busy(busy_ms: float, where: str, dts: list, steps: int, device_name: str) -> None:
    """The traced window's device busy ms a step, and its share of that
    window and of the median untraced window (the profiler's own host
    cost slows the traced one)."""
    if device_name == "cpu":
        parallel.print0(f"# trace of window 1 written to {where}; device busy not measured on "
                        "the CPU", file=sys.stderr)
        return
    step_ms = [d * 1e3 / steps for d in dts]
    line = (f"# trace of window 1 written to {where}: device busy {busy_ms / steps:.2f} "
            f"ms/step, {busy_ms / steps / step_ms[0]:.1%} of the traced window "
            f"({step_ms[0]:.2f} ms/step)")
    if len(dts) > 1:
        rest = sorted(step_ms[1:])
        median = rest[len(rest) // 2] if len(rest) % 2 else 0.5 * (
            rest[len(rest) // 2 - 1] + rest[len(rest) // 2])
        line += f", {busy_ms / steps / median:.1%} of the median untraced one ({median:.2f} ms/step)"
    parallel.print0(f"{line} [{device_name}]", file=sys.stderr)


def _host_epoch(env: _Env, mode: _Mode, verbose: bool):
    """The SimCLR step on JPEG files: ``(steps + 1)·B`` files made from seed
    0, decoded by this rank's :class:`HostLoader` shard (``BENCH_CACHE``:
    filled by an untimed warm epoch), copied to the device
    ``BENCH_DEV_PREFETCH`` batches ahead; one warm-up step, then ``steps``
    timed. Returns the epoch's wall seconds, the launches and the last
    batch."""
    from multimodal_active_ai_tpu_torch.data.loader import HostLoader
    from multimodal_active_ai_tpu_torch.data.prefetch import device_batches

    knobs = env.knobs
    files = _jpeg_corpus((env.steps + 1) * env.global_batch, int(knobs.get("BENCH_SRC", "640")))
    workers = int(knobs.get("BENCH_WORKERS", "0")) or min(os.cpu_count() or 8, 32)
    # few-core hosts: a producer thread's lock-holding copies starve the
    # host-to-device transfer, so production is synchronous there
    prefetch = int(knobs.get("BENCH_PREFETCH", "0" if (os.cpu_count() or 1) < 4 else "3"))
    depth = int(knobs.get("BENCH_DEV_PREFETCH", "2"))
    loader = HostLoader(files, batch_size=env.batch, canvas_size=env.canvas,
                        shard_id=parallel.rank(), num_shards=env.world, num_threads=workers,
                        prefetch=prefetch, cache_dir=knobs.get("BENCH_CACHE") or None,
                        pin_memory=env.on_card)
    if loader.cache is not None:
        for _ in iter(loader):       # warm epoch: decode and fill the cache
            pass
        if verbose:
            parallel.print0(f"# warm epoch {loader.stats_line()}", file=sys.stderr)
        loader.reset()
    with closing(device_batches(loader, env.device, depth)) as batches:
        images = next(batches)[0]
        mode.run_one(0, images)
        synchronize(env.device)
        before = _counts()
        t0 = perf_counter()
        for i in range(env.steps):
            images = next(batches)[0]
            mode.run_one(i + 1, images)
        synchronize(env.device)
        dt = perf_counter() - t0
    parallel.print0(f"# host input: {workers} decode threads, producer prefetch {prefetch}, "
                    f"device prefetch {depth}, cache {'on' if loader.cache else 'off'}; timed "
                    f"epoch {loader.stats_line()}", file=sys.stderr)
    return dt, _since(before), images


def _print_mfu(env: _Env, mode: _Mode, batch, step_s: float, device: dict) -> None:
    """Count one warm step's FLOPs with ``FlopCounterMode`` (the analogue of
    XLA's ``cost_analysis()``) and print the share of the peak. It counts
    convolutions and products (forward and backward) and nothing else; the
    port's kernels launch through ``ctypes`` and are invisible to it (B1 and
    B2 do no products; B3's products are refused with the mode). On the
    CPU, B1's plain version's window contractions are counted too."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        mode.run_one(env.windows * env.steps + 1, batch)
        synchronize(env.device)
    flops = counter.get_total_flops()
    head = (f"# MFU: {flops / 1e9:.3f} GFLOP/step ({flops} FLOP, FlopCounterMode: "
            f"convolutions and products)")
    if not env.on_card:
        parallel.print0(f"{head}; MFU not measured on the CPU", file=sys.stderr)
        return
    peak = float(env.knobs.get("BENCH_PEAK_TFLOPS", str(H100_BF16_TFLOPS))) * 1e12
    parallel.print0(f"{head}, {step_s * 1e3:.2f} ms/step -> {flops / step_s / peak:.1%} of "
                    f"{peak / 1e12:.0f} TF/s peak/chip [{device['name']}, "
                    f"{device['power_limit']}]", file=sys.stderr)


MODES = {"detr": _detr, "probe": _probe, "rls": _rls, "captions": _captions}


def main(env: Mapping[str, str] | None = None, argv=()) -> dict:
    """Run the bench with the ``BENCH_*`` knobs of ``env`` (``os.environ``
    when None) and ``argv`` (``--input=host``); print the JSON record on
    rank 0 and return it."""
    knobs = os.environ if env is None else env
    device = parallel.initialize_distributed(knobs.get("BENCH_DEVICE", "cuda"))
    try:
        return _run(knobs, device, argv)
    finally:
        parallel.shutdown()


def _run(knobs: Mapping[str, str], device: torch.device, argv) -> dict:
    for key, why in JAX_ONLY.items():
        if knobs.get(key):
            parallel.print0(f"# {key} ignored: {why}", file=sys.stderr)
    # bf16 is the fast path (autocast); what runs in float32 stays float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = _Env(knobs, device)
    info = _device_info(device)
    name = info["name"] if "power_limit" not in info else f"{info['name']}, {info['power_limit']}"
    trace_dir = knobs.get("BENCH_TRACE") or None
    mode_name = knobs.get("BENCH_MODE") or None
    input_mode = knobs.get("BENCH_INPUT", "device")
    for a in argv:
        if a.startswith("--input="):
            input_mode = a.split("=", 1)[1]
    verbose = bool(knobs.get("BENCH_VERBOSE"))
    mfu = mode_name is None and bool(knobs.get("BENCH_MFU"))
    host = mode_name is None and input_mode == "host"
    batch = None
    if mode_name in MODES:
        mode = MODES[mode_name](env)
    elif mode_name:
        raise ValueError(f"BENCH_MODE={mode_name}: not one of {sorted(MODES)} (or unset)")
    else:
        if mfu and knobs.get("BENCH_STATS") == "pallas":
            raise ValueError("BENCH_MFU with BENCH_STATS=pallas: the conv1x1_stats kernel's "
                             "products launch through ctypes, where FlopCounterMode cannot "
                             "count them")
        mode = _simclr(env, host)
    if host:
        dt, launches, batch = _host_epoch(env, mode, verbose)
        record = {"metric": mode.metric, "value": round(mode.units * env.steps / dt / env.world, 2),
                  "unit": "images/sec/chip"}
        dts = [dt]
    else:
        dts, launches = _timed_windows(env, mode, trace_dir, name)
        rates, median = _window_rates(dts, mode.units * env.steps, env.world)
        record = {"metric": mode.metric, "value": round(rates[-1], 2), "unit": "images/sec/chip",
                  "windows_img_s_chip": [round(r, 2) for r in rates],
                  "median_img_s_chip": round(median, 2)}
    record.update(mode.labels)
    record["device"] = info
    record["launches"] = launches
    parallel.print0(json.dumps(record))
    if verbose:
        parallel.print0(f"# devices={env.world} global_batch={env.global_batch} "
                        f"canvas={env.canvas} steps={env.steps} windows={len(dts)} "
                        f"best window={min(dts):.3f}s [{name}]", file=sys.stderr)
    if mfu:
        _print_mfu(env, mode, batch, min(dts) / env.steps, info)
    return record


def cli() -> int:
    """Console entry point (``maai-torch-bench``): exit 0 on success."""
    main(argv=sys.argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(cli())
