#!/usr/bin/env python3
"""Proof that the PyTorch/CUDA port trains on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. Build every CUDA kernel of the port from ``csrc/`` with ``nvcc`` (one
   process per source, all started together: B1 and B4 in
   ``glimpse_sample.cu``, B2 ``stat_sums.cu``, B3 ``conv1x1_stats.cu``, the
   fused BatchNorm + ReLU ``bn_act.cu``) and print what ``-Xptxas -v``
   reports, plus the card's name and power limit; fail if B3's wgmma
   kernels or the bn_act kernels spill.
2. Hold each kernel against its plain PyTorch version on the card at the
   shapes its path gives it, plus edge cases (B2 and B3 forward and
   backward; B1 and B4 on each of their routes), and time kernel, plain
   version, the nearest library call and the bound (bytes or operations
   over the card's peak rate), printing each shape's share of its bound
   and B1's, B3's and B4's routes (fatal if a main-path shape leaves its
   route). B1 is also held at the labeled plan of the probe and DETR
   paths (F=2: F*B = 256 rows over the B = 128 pyramid) and timed there.
   The four bn_act kernels (``ops/bn_act.py``: statistics with the running
   update, the apply pass with the residual and ReLU, the gradient sums
   and the gradient pass) against their plain versions at every ``(rows,
   C)`` and kind of call of the ResNet-50 b=256 forward, plus float32, the
   scalar route and a clamped variance, timed beside their bound, the
   plain versions and ``F.batch_norm``. Then hold
   small float32 train steps on the card against the same steps on the
   CPU: ResNet10, and ResNet-50 with ``norm_kind='bn_fused'`` and
   ``stat_fusion='pallas'``; and that fused ResNet-50 at b=1, whose 1x1
   convs have row counts that are not multiples of 8, against the unfused
   one on the card, counting its B2 and B3 launches and the unfused one's
   bn_act launches (53 statistics and 53 apply passes).
3. Drive the main path through its user entry point,
   ``multimodal_active_ai_tpu_torch.contrastive_learning.main``: SimCLR
   with saccades, ResNet-50, b=128, F=10, canvas 640, 3 train steps and
   validation, with the launch counters set to 0 just before and read just
   after (B1 1+F a train step and 2 an eval step; bn_act 583 statistics
   and apply launches and 530 of each backward kernel a train step, none
   in eval mode; B2-B4 none); then resume from the checkpoint it wrote,
   and time further steps.
3b. The same driver run with ``--stat-fusion pallas`` (B3 launched
   3·11·36 = 1188 times, B1 35, bn_act at the stem's norm alone), its
   resume, and train steps of the
   ``norm_kind='bn_fused'`` + ``stat_fusion='pallas'`` model (B2 187 and B3
   396 launches a step), each with its counters set to 0 just before and
   read just after; median step times of all three configurations.
3c. The linear-probe driver, ``representation_evaluation.main``, from the
   phase-3 SimCLR checkpoint (ResNet-50 encoder frozen in eval mode, b=128,
   F=2, canvas 640, bf16, 3 train steps and validation), then its resume:
   B1 launched once a train and an eval step, B2, B3, B4 and bn_act never.
3d. The same for the DETR driver, ``detr_image_classification.main``, with
   its default model (6 + 6 layers, hidden 256, 8 heads, FFN 2048, 10
   queries, 1000 classes) on that ResNet-50 backbone; its frozen stem and
   layer1 unchanged and its ``aux_logits`` of the right shape. Median probe
   and DETR train steps, with peak memory.
3e. The RLS driver, ``detr_image_classification_rls.main``, from the same
   checkpoint: that DETR model, a ResNet18 DQN (A = 100, -dqnb 256, replay
   capacity 10,000), F=2, 3 train steps and validation, the target synced
   every epoch. B1 is launched once per fixation: F a train step and 2F an
   eval batch (the random control and the greedy policy), 10 in all; B2-B4
   never; the DQN updates are those the seed's coins give, each launching
   bn_act's four kernels at the DQN's 20 BatchNorms; three
   checkpoints (the best-model copy when top-1 beats 0), the target equal
   to the policy. Then its resume to epoch 2 (policy in the loop; its first
   step sees every tensor of both checkpoints), and the median RLS train
   step and DQN update. Phase 2 also holds B1 at the RLS plan (R = B =
   128 labeled rows, one fixation) and times it against its bound.
3f. The caption-probe driver, ``coco_captions_probe.main``, from the same
   checkpoint: the ResNet-50 encoder float32 and frozen, b=128, F=2, the
   text tower at its defaults (vocab 32768, d 256, 8 heads, 4 layers, FFN
   1024, max_len 32), 12 train and 5 eval steps (the driver's ``-t`` cut),
   then its resume. B1 is launched once a train and an eval step, 17 a run;
   B2-B4 never; losses and retrieval top-1/5 finite; the encoder unchanged;
   the resume's first step sees every tensor of both towers; the median
   caption train step and the peak memory.
3g. Image files. An ImageNet-layout folder written from a seed with PIL
   (421 train images, 3 batches of 128 and a padded one of 37, 128 val, 8
   class directories; sources 300x225 to 800x600; RGB JPEG at quality 90,
   1 in 16 grayscale JPEG, 1 in 32 RGBA PNG); its size, the host's cores and
   the decoder. (1) A pinned, threaded ``HostLoader`` through
   ``device_batches`` at depth 2 beside a SimCLR step on each batch, every
   device batch equal bit for bit to a synchronous unpinned CPU loader's,
   over two shuffled epochs. (2) The SimCLR driver at the phase-3 width with
   ``--dataset imagenet``, ``-v`` and a cold ``--canvas-cache``: B1 launched
   4*(1+10) + 2 = 46 times, B2-B4 never; its loader line 512 decoded (batch
   positions, the padded batch included), 0 hits. (3) Its resume to epoch
   2 from the cache: 0 decoded, 512 hits; its first step sees every tensor
   of the checkpoint. (4) The probe from that checkpoint, without and with
   the cache: B1 4 + 1. (5) The caption driver with ``--dataset
   imagefolder``: its corpus vocabulary, finite losses and retrieval, B1 one
   a step. The driver steps on files beside the synthetic ones of phases 3
   and 3c, the loader's produce and wait per batch, the peak memory and the
   phase's seconds.
3h. Data parallelism, as jobs of 2 ranks started with ``python -m
   torch.distributed.run`` (each rank this script with ``--rank-job``):
   NCCL where the machine has 2 cards, else 2 ranks sharing the one card
   over gloo (printed). (a) The SimCLR driver at the phase-3 width, ``-b
   128`` a rank (global 256), ``--multislice``; (b) B1 launched 35 times on
   each rank, B2-B4 never, both ranks' weights bit-identical and equal to
   the checkpoint rank 0 alone writes, the losses finite; a 1-rank job
   runs the port's collectives on the card over NCCL. (c) A float32
   ResNet10 step at 2 ranks x 4 rows equals the 1-rank step of the 8 rows
   on the card. (d) The probe, DETR, RLS and caption drivers at 2 ranks, 2
   train steps each, from the phase-3 checkpoint: B1 per rank as each path
   launches it, rank 0 alone writing. (e) The step time a rank, the global
   img/s and the peak memory beside the card's name and power limit,
   labelled when the ranks share a card.
3i. A JAX-package checkpoint on the card. The machine has no JAX, so the
   script writes the JAX SimCLR driver's msgpack of the phase-3 state itself
   (``flax_msgpack_bytes``: flax's bytes; ``to_jax_simclr``: the inverse of
   the port's weight map, for the weights and Adam's moments; optax's
   ``adam`` chain with its counts), then resumes the SimCLR driver from it
   and from the port's own ``.pth.tar`` (epoch 1 of 2, cuDNN
   deterministic): the first resumed step's losses and the weights and
   BatchNorm statistics after it bit-identical (``num_batches_tracked``,
   which the JAX layout lacks and the port never reads, apart); B1 35
   launches each, B2-B4 none.
3j. The retina's ``canvas`` mode on the card against
   ``tests/data/dali_golden.npz`` (mean |d| < 1.5, p99 < 7) and against the
   CPU (<= 1e-3 on the 0..255 scale); the ``fused`` mode against the CPU at
   b=128, canvas 640 (|d| <= 1e-2 + 1e-4|cpu| but for at most 1e-4 of
   the elements); the ms of one view of each; 3 SimCLR train steps with
   each mode at the phase-3 width: median step, peak memory, B1 never.
3k. The last modules. (a) Dropout: the DETR driver at phase 3d's width
   from the phase-3 checkpoint with ``--dropout 0.1``: every train-mode
   attention keep mask one ``(Sq, Sk)`` pattern for all rows and heads, the
   keep rate within 4σ of 0.9; two runs at ``--seed 15`` with bit-identical
   first-step losses (cuDNN deterministic; the later steps' largest
   difference printed) and ``--seed 16`` with another; the elements the
   DETR and caption steps draw, their device ms alone and each step (host
   median and one traced step's device busy ms) with dropout 0.1 beside 0. The DETR, RLS and caption drivers of phases 3d-3f
   run with dropout at their defaults (0.1) and keep their B1 counts.
   (b) ``AsyncCheckpointer``: the SimCLR driver at the phase-3 width for 2
   epochs of 2 steps, the training thread's stall at each epoch-end save
   beside an inline save of the same payload; save, a train step, wait():
   the file holds the weights and Adam moments of the save. (c)
   ``utils/profiling``: a SimCLR step traced by ``trace``, its device busy
   from ``device_leaf_ops`` within 1% of the same trace's JSON file, and
   ``tools/profile_torch_step.trace`` on the next step beside it;
   ``StepTimer`` and ``device_memory_stats``. (d)
   ``legacy_resnet18`` on ``(1, 20, 30, 15)`` and ``resnet1d_101`` on
   ``(1, 5008, 1)`` against their CPU forwards (1e-4), a ``legacy_resnet50``
   train step at b=128 on 30x30x15, timed. (e) The four example twins, B1
   launched 5 times by the contrastive demo and 3 by the captioner demo.
   (f) ``--unroll-fixations 5`` against 0: the same losses over 2 steps.
3l. The convergence suite (``tools/torch_convergence.py``): (a) the seven
   cases of the JAX package's ``tests/test_convergence.py`` (SimCLR
   overfit, linear probe, DETR overfit, DQN greedy against random, caption
   retrieval, the glimpse captioner, RLS learned against random saccades)
   on the card in float32, TF32 off, each held to the JAX test's
   thresholds, with its numbers and seconds; (b) each case's launches
   against the count its code implies (B1 once a retina call, 0 in the DQN
   and captioner cases; B2-B4 never); (c) case 1 with ``bn_fused`` (B2
   2400 times) to the same thresholds; case 1 at ResNet50 for 20 steps
   from one init and seed, each step run from the ``bn`` run's state by
   ``bn`` and by ``bn_fused`` + ``pallas`` (B2 680, B3 1440 times):
   per-step losses within 1%; then the two trained apart, their drift
   printed, not held (float32 rounding grows through Adam; ``bn`` drifts
   as far from its own rerun and further from a float64 run:
   ``tools/torch_fused_drift.py``); (d) the loss-curve
   configuration of ``tools/loss_curve_parity.py`` from one torch-seeded
   init on the CPU and on the card, 20 steps: per-update losses within 1%.
   (e) ResNet-50 SimCLR updates (b=128, F=1, eight seeds) with the fused
   BatchNorm kernels against the same updates with the unfused chain, in
   float32 and in bf16, and a control with each norm's output rounded to
   float8 e4m3's 3 mantissa bits, which has to fall outside the bf16
   limits: losses, gradient norms and directions, running statistics,
   the launches (2 x 53 forward, 53 each backward kernel); then one bf16
   step at F=10 launching ``bn_act_apply`` 583 times and each backward
   kernel 530 times, timed beside the chain's.
   The ``kernels`` line carries case 1's B1 count and the fused ResNet50
   run's B2 and B3 counts as ``convergence_launches`` (bn_act: (e)'s F=10
   step; its ``launches`` the main path's).
3m. The port's bench, ``multimodal_active_ai_tpu_torch.bench.main``, run
   in-process as a user runs ``python -m multimodal_active_ai_tpu_torch.
   bench``: the five modes (SimCLR train, DETR inference, probe, RLS,
   captions) at ``bench.py``'s card defaults (b=128, canvas 640, 10 steps,
   3 windows; SimCLR ResNet50 F=10, the downstream modes ResNet18, RLS
   F=4 with a DQN update every step); SimCLR with ``BENCH_MFU=1`` (5
   steps, 2 windows); SimCLR with ``BENCH_NORM=bn_fused
   BENCH_STATS=pallas`` (3 steps, 2 windows); SimCLR on JPEG files with
   ``BENCH_INPUT=host`` and ``BENCH_CACHE`` (5 steps); last, SimCLR with
   ``BENCH_TRACE`` (2 steps, 2 windows). Each with the
   counters set to 0 just before and read just after, held to the launches
   its steps imply (B1 1+F a SimCLR step, 1 a DETR, probe or caption step,
   F an RLS step; B2 (1+F)*17 and B3 (1+F)*36 a fused step; the warm-up
   step and the MFU step included), its record's own ``launches`` to the
   timed windows' share, every rate finite and above 0, and the record's
   ``device`` the card. One line a run with the rates, the launches, the
   peak memory and the card's name and power limit; the MFU and trace
   lines; the phase's seconds.
3n. The JAX package's driver-level learning run (``tools/
   torch_learning_run.py``) cut in epochs, and its last diagnostics as port
   tools. (a) The JAX run's corpus (``tools/make_tiny_imagefolder.py``: 10
   classes x 96 train + 16 val JPEGs at 640 px, seed 0) and the
   wide-stripe cue corpus (4 classes x 120 + 24), the canvas cache under
   ``/dev/shm``. (b) The part-1 and part-2 legs through each driver's
   ``main`` at the JAX commands' widths (ResNet-50, canvas 640, b=96, F=5;
   captions b=64): SimCLR 3 epochs, the probe, DETR and RLS 6 each and
   captions 10, each from the SimCLR leg's ``model_best.pth.tar``; each
   leg's per-epoch numbers beside the JAX TPU run's, its best top-1 (I2T
   and T2I for captions; random control and policy for RLS) at least 2x
   chance (SimCLR: finite losses), B1 launched as its code implies
   (SimCLR ``steps·(1+F) + 2·eval_steps``; probe, DETR and captions one a
   train and an eval step; RLS F a train step and 2F an eval batch), B2-B4
   never. (c) ``tools/torch_cue_linear_probe.py`` on the cue corpus (R=3,
   b=48): oracle val per-fix and random img-mean above chance + 0.15 beside
   the JAX run's 0.701 / 0.938 / 1.000, B1 twice a batch. (d)
   ``tools/torch_rls_cue_diag.py``'s from-init arm, 10 steps at b=48 on the
   same corpus: finite CE, B1 3 a step. (e) ``tools/torch_bn_stat_bench.py``:
   B2 within phase 2's tolerance of its plain version at all eight
   ResNet-50 b=128 shapes, the ``bn`` form and B2 timed (ms, GB/s, share of
   3.35 TB/s), B2's launches counted. Phase 3h also runs
   ``tools/torch_multiprocess_check.py`` as a 2-rank job (3h(f)).
3o. The generative caption step (``train/caption_lm.py``) at the shapes of
   the benchmark's Kimi-VL-A3B cell: Kimi-VL-A3B's language model (27
   layers, MLA, 26 MoE layers holding experts 0-7 of 64, vocabulary slice
   20,480) behind the projector over a frozen ResNet-50, b=16, F=128, 64
   text positions. (a) Which SDPA backends take MLA's query and key of 192
   against a value of 128 (forward and backward, bf16), and the kernels
   the default picks. (b) One MoE layer at the cell's 9,216 rows: the
   grouped product against the loop over the 8 held experts, forward and
   backward, within bf16's rounding, each timed. (c) Before any update,
   the share of top-6 choices, per MoE layer, that differ between the
   bf16 program and the float32 reference (``reference/mla_moe.py``) on
   the same weights and batch, with the routers' correction bias at 0 and
   balanced on the batch (as the cell's seed weights are). (d) Train steps: finite losses, the MoE
   counters (26 calls a step), the median step, peak memory. ``python3
   chip_smoke.py --caption-lm`` runs this phase alone.
4. Print ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

It imports nothing of JAX. It exits non-zero without CUDA, and when the
port package is not beside it.
"""

from __future__ import annotations

import gc
import json
import math
import os
from collections import Counter
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "multimodal_active_ai_tpu_torch"

# NVIDIA H100 SXM data-sheet peaks (dense): HBM3 bandwidth, the
# non-tensor-core float32 rate and the bf16 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_TENSOR_FLOPS = 989e12

ARCH, BATCH, FIXATIONS, CANVAS, EXAMPLES = "ResNet50", 128, 10, 640, 384
PROBE_FIXATIONS = 2     # -f of the probe and DETR paths
RTOL, ATOL = 1e-2, 1e-1


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, torch, iters: int, flush) -> float:
    """Mean device time of ``fn`` over ``iters`` calls with a cold L2: each
    call follows an L2 flush, and the flushes' own time is subtracted. The
    stream first sleeps ~25 ms, so the host queues every call before the
    timed ones start and host launch gaps do not count as device time."""
    def run(with_fn: bool) -> float:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(iters):
            flush()
            if with_fn:
                fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop)
    fn()
    run(True)  # warm-up
    return max(run(True) - run(False), 0.0) / iters


def touched_pixels(torch, mip, rows, rel_y, rel_x, start, win) -> int:
    """Distinct mip pixels that some nonzero-weight tap of one level reads;
    ``rel_y``/``rel_x`` ``(B, P)``, ``start`` ``(B, 2)``, plan row ``b``
    reads mip image ``rows[b]``."""
    m = mip.shape[1]
    s = start.long().clamp(0, m - win)
    ry = rel_y.clamp(0, win - 1)
    rxa = (rel_x + s[:, 1:2]).clamp(s[:, 1:2].float(), (s[:, 1:2] + win - 1).float())
    y0 = ry.floor()
    x0 = rxa.floor()
    taps = []
    for dy in (0, 1):
        for dx in (0, 1):
            keep = torch.ones_like(ry, dtype=torch.bool)
            if dy:
                keep &= (ry - y0) > 0
            if dx:
                keep &= (rxa - x0) > 0
            y = s[:, 0:1] + y0.long() + dy
            x = x0.long() + dx
            taps.append(((rows[:, None] * m + y) * m + x)[keep])
    return torch.unique(torch.cat(taps)).numel()


def glimpse_bound(torch, mips, rel_y, rel_x, start, scale, wins):
    """Least bytes the sampler must move for these inputs and the flops it
    does: outputs written once, rel/scale/start read once, and each mip
    pixel that some nonzero-weight tap touches read once (6 bytes, bf16
    RGB). Returns ``(bytes, flops)``."""
    b, levels, p = rel_y.shape
    nbytes = b * 3 * levels * p * 4 + 3 * b * levels * p * 4 + start.numel() * 4
    rows = torch.arange(b, device=rel_y.device) % mips[0].shape[0]
    for li, (mip, win) in enumerate(zip(mips, wins)):
        nbytes += 6 * touched_pixels(torch, mip, rows, rel_y[:, li], rel_x[:, li],
                                     start[:, li], win)
    flops = b * levels * p * (4 * 3 * 2 + 16)  # 4 taps x 3 ch mul-add + weights/clamps
    return nbytes, flops


def bound(nbytes: float, t_ops_s: float) -> tuple[float, str]:
    """``(bound_ms, bound_by)``: the larger of the bytes over the memory
    rate and the operations' time at their peak rate."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_bytes, t_ops_s) * 1e3, "bytes" if t_bytes >= t_ops_s else "operations"


def bound_by(totals: Counter) -> str:
    """What bounds a sum of calls: the larger of its bytes-bound and
    operations-bound parts."""
    return "bytes" if totals["bound_bytes"] >= totals["bound_operations"] else "operations"


def normwise_err(got, ref) -> tuple[float, float]:
    """``(max |got - ref|, that over max |ref|)`` in float32."""
    err = float((got.float() - ref.float()).abs().max())
    return err, err / max(float(ref.float().abs().max()), 1e-30)


def resnet50_fused_shapes(batch: int) -> tuple[Counter, Counter]:
    """One train-mode forward of ResNet-50 (30x30 glimpses) with
    ``norm_kind='bn_fused'`` and ``stat_fusion='pallas'``: the ``(N, C)``
    of each B2 call (stem BN and the 3x3 convs' BNs) and the ``(M, K, N)``
    of each B3 call (the Bottleneck 1x1 convs and projections), counted."""
    b2, b3 = Counter(), Counter()
    side, inplanes = 30, 64
    b2[(batch * side * side, 64)] += 1
    for planes, blocks, stride in zip((64, 128, 256, 512), (3, 4, 6, 3), (1, 2, 2, 2)):
        for i in range(blocks):
            s = stride if i == 0 else 1
            out = (side - 1) // s + 1
            m_in, m_out = batch * side * side, batch * out * out
            b3[(m_in, inplanes, planes)] += 1                 # conv1
            b2[(m_out, planes)] += 1                          # bn2 after the 3x3
            b3[(m_out, planes, 4 * planes)] += 1              # conv3
            if s != 1 or inplanes != 4 * planes:
                b3[(m_out, inplanes, 4 * planes)] += 1        # downsample
            inplanes, side = 4 * planes, out
    return b2, b3


# expansion and blocks a stage of the ResNets whose BatchNorms bn_act runs
RESNET_LAYERS = {"ResNet10": (1, (1, 1, 1, 1)), "ResNet18": (1, (2, 2, 2, 2)),
                 "ResNet50": (4, (3, 4, 6, 3))}


def resnet_bn_calls(arch: str, batch: int) -> Counter:
    """One train-mode forward of the foveated ResNet ``arch`` (30x30
    glimpses) with ``norm_kind='bn'``: the ``(rows, C, kind)`` of each
    BatchNorm, which on the card is one ``bn_act`` call, counted (53 for
    ResNet-50, 20 for ResNet-18). ``kind``: ``relu`` (a norm and its ReLU),
    ``shortcut`` (the downsample's norm, no ReLU), ``residual`` (a block's
    last norm, the residual add and the ReLU)."""
    expansion, layers = RESNET_LAYERS[arch]
    calls = Counter()
    side, inplanes = 30, 64
    calls[(batch * side * side, 64, "relu")] += 1                   # stem
    for planes, blocks, stride in zip((64, 128, 256, 512), layers, (1, 2, 2, 2)):
        for i in range(blocks):
            s = stride if i == 0 else 1
            out = (side - 1) // s + 1
            rows_in, rows_out = batch * side * side, batch * out * out
            if expansion == 4:
                calls[(rows_in, planes, "relu")] += 1               # bn1, after the 1x1
                calls[(rows_out, planes, "relu")] += 1              # bn2, after the 3x3
            else:
                calls[(rows_out, planes, "relu")] += 1              # bn1
            calls[(rows_out, expansion * planes, "residual")] += 1
            if s != 1 or inplanes != expansion * planes:
                calls[(rows_out, expansion * planes, "shortcut")] += 1
            inplanes, side = expansion * planes, out
    return calls


BN_ACT_KERNELS = ("bn_act_stats", "bn_act_apply", "bn_act_grad_sums", "bn_act_grad_apply")


def bn_act_launches(forwards: int, backwards: int, norms: int) -> dict:
    """The launches of ``bn_act``'s four kernels in ``forwards`` train-mode
    forwards and ``backwards`` backwards of a model with ``norms`` fused
    BatchNorms: the statistics and the apply pass once a norm a forward,
    each backward kernel once a norm a backward."""
    return dict(zip(BN_ACT_KERNELS, (forwards * norms,) * 2 + (backwards * norms,) * 2))


def resnet_bn_shapes(arch: str, batch: int) -> Counter:
    """The ``(rows, C)`` of :func:`resnet_bn_calls`, counted."""
    shapes = Counter()
    for (n, c, _), k in resnet_bn_calls(arch, batch).items():
        shapes[(n, c)] += k
    return shapes


def odd_mip_plan(torch, gen, b: int, p: int, m: int = 45, win: int = 40):
    """One level on a mip of odd side, which sends B1 and B4 to their
    2-byte gathers: random bf16 pixels, window origins past both ends of the
    mip, coordinates past both window edges, a 0/1 scale. Returns B1's
    arguments."""
    dev = torch.device("cuda")
    mip = (torch.rand(b, m, 3 * m, generator=gen, device=dev) * 255).to(torch.bfloat16)
    start = torch.randint(-3, m - win + 4, (b, 1, 2), generator=gen, device=dev,
                          dtype=torch.int32)
    rel = torch.rand(b, 1, p, 2, generator=gen, device=dev) * (win + 4) - 2
    scale = (torch.rand(b, 1, p, generator=gen, device=dev) > 0.2).float()
    return ([mip], rel[..., 0].contiguous(), rel[..., 1].contiguous(), start, scale,
            [win], [m])


def check_glimpse_sample(torch, gs, retina):
    """Phase 2: kernel vs plain on the main path's plan, edge cases and
    both routes of each kind (16-byte and scalar coordinates and output,
    32-bit-word and 2-byte gathers), the same bits on a second call; times.
    A case that leaves the route its shape calls for is fatal."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    images = torch.randint(0, 256, (BATCH, CANVAS, CANVAS, 3), generator=gen,
                           dtype=torch.uint8, device=dev)
    cfg = retina.RetinaConfig(canvas_size=CANVAS, grid_mask_prob=1.0)
    pyramid = retina.build_pyramid(images, cfg)
    params = retina.sample_unlabeled_params(gen, BATCH, CANVAS, cfg)
    if not (bool(params.flip.any()) and bool((params.gm_ratio > 0).all())
            and bool((params.angle != 0).any())):
        fail("the plan does not exercise flip, rotation and the grid mask")
    args = retina.sampler_args(pyramid, params, cfg)
    mips, rel_y, rel_x, start, scale, wins, msizes = args

    def compare(label, a, want):
        got = gs.glimpse_sample(*a)
        plan = gs.glimpse_sample.plan
        again = gs.glimpse_sample(*a)
        ref = gs.glimpse_sample_plain(*a)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        max_abs = float(err.max())
        max_rel = float((err / ref.abs().clamp_min(1e-3)).max())
        same = torch.equal(got, again)
        ok = bool(torch.allclose(got, ref, rtol=RTOL, atol=ATOL)) and same
        route = (plan.route, plan.gather)
        print(f"glimpse_sample {label} [{', '.join(route)}]: shape {tuple(got.shape)} "
              f"max_abs_err {max_abs:.4g} max_rel_err {max_rel:.4g} (rtol={RTOL}, "
              f"atol={ATOL}), same bits on a second call {same} {'ok' if ok else 'MISMATCH'}")
        if not ok or not bool(torch.isfinite(got).all()):
            fail(f"glimpse_sample {label} disagrees with glimpse_sample_plain")
        if route != want:
            fail(f"glimpse_sample {label} takes the {route} route, expected {want}")
        return max_abs

    main = ("vec16", "pairs")
    errs = [compare("main-path plan (B=128, L=4, P=900)", args, main)]

    # tail clamp: windows flush with the mip's end, taps on the last row/col
    tail_start = start.clone()
    tail_y, tail_x = rel_y.clone(), rel_x.clone()
    for li, (mip, win) in enumerate(zip(mips, wins)):
        m = mip.shape[1]
        tail_start[:, li] = m - win
        tail_y[:, li, :64] = win - 1.0
        tail_x[:, li, :64] = win - 1.0
        tail_y[:, li, 64:128] = win - 1.0
    errs.append(compare("tail clamp (start = M - win, ry = win - 1)",
                        (mips, tail_y, tail_x, tail_start, scale, wins, msizes), main))

    # multi-view plan: V·B rows against the B-image pyramid
    views = 3
    pv = retina.sample_unlabeled_params(gen, views * BATCH, CANVAS, cfg)
    errs.append(compare(f"multi-view plan (V={views}, V*B={views * BATCH})",
                        retina.sampler_args(pyramid, pv, cfg), main))

    # P not a multiple of 4: the scalar route, at the main path's size and tiny
    for p in (899, 13):
        cut = [t[..., :p].contiguous() for t in (rel_y, rel_x, scale)]
        errs.append(compare(f"main-path plan cut to P={p}",
                            (mips, cut[0], cut[1], start, cut[2], wins, msizes),
                            ("scalar", "pairs")))
    # a mip of odd side: 2-byte gathers, on both routes
    for p, route in ((900, "vec16"), (13, "scalar")):
        errs.append(compare(f"odd mip side (M=45, win=40, B={BATCH}, P={p})",
                            odd_mip_plan(torch, gen, BATCH, p), (route, "taps")))

    # the labeled plan of the probe and DETR paths: F*B rows (no rotation,
    # no crop, a random fixation) over the B-image pyramid
    lab_cfg = retina.RetinaConfig(canvas_size=CANVAS)
    lab_params = retina.sample_labeled_params(gen, PROBE_FIXATIONS * BATCH, CANVAS)
    lab_args = retina.sampler_args(pyramid, lab_params, lab_cfg)
    errs.append(compare(f"labeled plan (F={PROBE_FIXATIONS}, F*B={PROBE_FIXATIONS * BATCH})",
                        lab_args, main))
    # the RLS plan: one fixation of the sequential rollout, R = B labeled
    # rows over the B-image pyramid
    rls_args = retina.sampler_args(pyramid, retina.sample_labeled_params(gen, BATCH, CANVAS),
                                   lab_cfg)
    errs.append(compare(f"RLS plan (one fixation, R=B={BATCH})", rls_args, main))

    # times at the main-path shapes, L2 flushed before each call
    flush_buf = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    kernel_ms = time_ms(lambda: gs.glimpse_sample(*args), torch, 50, flush)
    plain_ms = time_ms(lambda: gs.glimpse_sample_plain(*args), torch, 5, flush)

    # nearest library call (yardstick only; the port never calls it):
    # one bilinear F.grid_sample per level on float32 NCHW mips, edge
    # handling 'border' rather than the window clamp, no scale multiply
    import torch.nn.functional as F
    lib_in, lib_grid = [], []
    for li, (mip, win) in enumerate(zip(mips, wins)):
        m = mip.shape[1]
        img = mip.view(BATCH, m, m, 3).permute(0, 3, 1, 2).float().contiguous()
        s = start[:, li].float()
        ay = rel_y[:, li] + s[:, 0:1]
        ax = rel_x[:, li] + s[:, 1:2]
        grid = torch.stack([ax, ay], -1)[:, None] * (2.0 / (m - 1)) - 1.0
        lib_in.append(img)
        lib_grid.append(grid.contiguous())

    def library():
        for img, grid in zip(lib_in, lib_grid):
            F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                          align_corners=True)
    library_ms = time_ms(library, torch, 20, flush)

    nbytes, flops = glimpse_bound(torch, mips, rel_y, rel_x, start, scale, wins)
    bound_ms, by = bound(nbytes, flops / PEAK_F32_FLOPS)
    print(f"glimpse_sample times (B=128, L=4, P=900) [{', '.join(main)}]: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library (4x F.grid_sample, "
          f"approximate yardstick) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({nbytes / 1e6:.2f} MB at 3.35 TB/s; {flops / 1e6:.1f} MFLOP); "
          f"{100 * bound_ms / kernel_ms:.1f}% of the bound (target 50%)")
    lab_ms = time_ms(lambda: gs.glimpse_sample(*lab_args), torch, 50, flush)
    lab_plain_ms = time_ms(lambda: gs.glimpse_sample_plain(*lab_args), torch, 5, flush)
    lab_bytes, lab_flops = glimpse_bound(torch, *lab_args[:6])
    lab_bound_ms, lab_by = bound(lab_bytes, lab_flops / PEAK_F32_FLOPS)
    print(f"glimpse_sample times, labeled plan (F*B={PROBE_FIXATIONS * BATCH} over B={BATCH}, "
          f"L=4, P=900) [{', '.join(main)}]: kernel {lab_ms:.4f} ms, plain {lab_plain_ms:.4f} "
          f"ms, bound {lab_bound_ms:.4f} ms ({lab_by}: {lab_bytes / 1e6:.2f} MB); "
          f"{100 * lab_bound_ms / lab_ms:.1f}% of the bound")
    rls_ms = time_ms(lambda: gs.glimpse_sample(*rls_args), torch, 50, flush)
    rls_plain_ms = time_ms(lambda: gs.glimpse_sample_plain(*rls_args), torch, 5, flush)
    rls_bytes, rls_flops = glimpse_bound(torch, *rls_args[:6])
    rls_bound_ms, rls_by = bound(rls_bytes, rls_flops / PEAK_F32_FLOPS)
    print(f"glimpse_sample times, RLS plan (one fixation, R=B={BATCH}, L=4, P=900) "
          f"[{', '.join(main)}]: kernel {rls_ms:.4f} ms, plain {rls_plain_ms:.4f} ms, bound "
          f"{rls_bound_ms:.4f} ms ({rls_by}: {rls_bytes / 1e6:.2f} MB); "
          f"{100 * rls_bound_ms / rls_ms:.1f}% of the bound")
    return {
        "name": "glimpse_sample",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/glimpse_sample.cu",
        "replaces": "multimodal_active_ai_tpu/ops/pallas_retina.py:269",
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": by,
        "library_ms": library_ms,
    }, args


def check_hat_sample(torch, gs, args):
    """Phase 2, B4: the one-level sampler at each level of the main path's
    plan (B=128, P=900), the edge clamp (window flush with the mip's end,
    coordinates past both window edges), P=13 (the scalar route) and a mip
    of odd side (2-byte gathers, both routes), against its plain version,
    the same bits on a second call; times summed over the four levels, and
    each level's time beside a launch's floor (a one-element ``zero_``)
    plus its bytes at 3.35 TB/s.

    Tolerance as B1's (rtol=1e-2, atol=1e-1): both sides round the y
    weights to bf16, but from 1 - fy computed in two ways, which can land
    one bf16 step apart (up to 255 x 2^-8 ~ 1 in a pixel)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    mips, rel_y, rel_x, start, _, wins, _ = args
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev).zero_
    floor_ms = time_ms(torch.zeros(1, device=dev).zero_, torch, 50, flush)
    errs, totals = [], Counter()

    def compare(label, a, want):
        got = gs.hat_sample(*a)
        plan = gs.hat_sample.plan
        again = gs.hat_sample(*a)
        ref = gs.hat_sample_plain(*a)
        torch.cuda.synchronize()
        same = torch.equal(got, again)
        ok = bool(torch.allclose(got, ref, rtol=RTOL, atol=ATOL)) and same
        err, rel = normwise_err(got, ref)
        route = (plan.route, plan.gather)
        print(f"hat_sample {label} [{', '.join(route)}]: shape {tuple(got.shape)} max_abs_err "
              f"{err:.4g} (normwise {rel:.3g}; rtol={RTOL}, atol={ATOL}), same bits on a "
              f"second call {same} {'ok' if ok else 'MISMATCH'}")
        if not ok or not bool(torch.isfinite(got).all()):
            fail(f"hat_sample {label} disagrees with hat_sample_plain")
        if route != want:
            fail(f"hat_sample {label} takes the {route} route, expected {want}")
        errs.append(err)

    b = rel_y.shape[0]
    rows = torch.arange(b, device=dev)
    for li, (mip, win) in enumerate(zip(mips, wins)):
        m = mip.shape[1]
        rel = torch.stack([rel_y[:, li], rel_x[:, li]], -1).contiguous()
        st = start[:, li].contiguous()
        a = (mip, rel, st, win)
        compare(f"level {li} (M={m}, win={win}, B={b}, P={rel.shape[1]})", a,
                ("vec16", "pairs"))
        edge = rel.clone()
        edge[:, :64] = win - 1.0
        edge[:, 64:96, 0] = -5.0
        edge[:, 96:128, 1] = win + 9.0
        compare(f"level {li} edge clamp", (mip, edge, torch.full_like(st, m - win), win),
                ("vec16", "pairs"))
        compare(f"level {li} P=13", (mip, rel[:, :13].contiguous(), st, win),
                ("scalar", "pairs"))

        kernel = time_ms(lambda: gs.hat_sample(*a), torch, 50, flush)
        plain = time_ms(lambda: gs.hat_sample_plain(*a), torch, 5, flush)
        img = mip.view(b, m, m, 3).permute(0, 3, 1, 2).float().contiguous()
        grid = (torch.stack([rel[..., 1] + st[:, 1:2], rel[..., 0] + st[:, 0:1]], -1)[:, None]
                * (2.0 / (m - 1)) - 1.0).contiguous()
        library = time_ms(lambda: F.grid_sample(img, grid, mode="bilinear",
                                                padding_mode="border", align_corners=True),
                          torch, 20, flush)
        p = rel.shape[1]
        nbytes = b * p * (3 + 2) * 4 + st.numel() * 4 + 6 * touched_pixels(
            torch, mip, rows, rel[..., 0], rel[..., 1], st, win)
        bms, by = bound(nbytes, b * p * (4 * 3 * 2 + 16) / PEAK_F32_FLOPS)
        print(f"hat_sample times level {li}: kernel {kernel:.4f} ms, plain {plain:.4f} ms, "
              f"library (F.grid_sample, approximate yardstick) {library:.4f} ms, bound "
              f"{bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB), launch floor + bytes "
              f"{floor_ms + bms:.4f} ms ({100 * (floor_ms + bms) / kernel:.1f}% of the kernel)")
        totals.update(kernel=kernel, plain=plain, library=library, bound=bms,
                      **{f"bound_{by}": bms})
    for p, route in ((900, "vec16"), (13, "scalar")):
        mip_, ry, rx, st, _, (win,), (m,) = odd_mip_plan(torch, torch.Generator(
            device=dev).manual_seed(p), b, p)
        compare(f"odd mip side (M={m}, win={win}, B={b}, P={p})",
                (mip_[0], torch.stack([ry[:, 0], rx[:, 0]], -1).contiguous(),
                 st[:, 0].contiguous(), win), (route, "taps"))
    print(f"hat_sample times, the four levels: kernel {totals['kernel']:.4f} ms, plain "
          f"{totals['plain']:.4f} ms, library {totals['library']:.4f} ms, bound "
          f"{totals['bound']:.4f} ms, four launch floors + bytes "
          f"{4 * floor_ms + totals['bound']:.4f} ms (floor {floor_ms:.4f} ms a launch)")
    return {
        "name": "hat_sample",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/glimpse_sample.cu",
        "replaces": "multimodal_active_ai_tpu/ops/pallas_retina.py:89",
        "max_abs_err": max(errs),
        "ms": totals["kernel"],
        "plain_ms": totals["plain"],
        "bound_ms": totals["bound"],
        "bound_by": bound_by(totals),
        "library_ms": totals["library"],
    }


def spills(log: str, kernel_fragment: str) -> list[str]:
    """The ``-Xptxas -v`` property lines of the kernels whose mangled name
    holds ``kernel_fragment`` and that spill registers."""
    bad, current = [], ""
    for line in log.splitlines():
        if "Function properties for" in line:
            current = line
        elif "spill" in line and kernel_fragment in current:
            stores, loads = (int(line.split(" bytes spill " + kind)[0].split()[-1])
                             for kind in ("stores", "loads"))
            if stores or loads:
                bad.append(f"{current.split()[-1]}: {line.strip()}")
    return bad


def check_stat_sums(torch, ss):
    """Phase 2, B2: ``stat_sums`` at every ``(N, C)`` of the ResNet-50 b=128
    ``bn_fused`` + ``stat_fusion='pallas'`` forward, in bf16 and float32,
    plus tails, against ``stat_sums_plain``, with the gradient; times at the
    main-path shapes (bf16), each and summed over one forward's 17 calls.

    Tolerance: both sides sum the same float32 values in other orders:
    normwise 1e-5 on the statistics and on the gradient."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev).zero_
    shapes, _ = resnet50_fused_shapes(BATCH)
    errs, totals = [], Counter()
    cases = [(n, c, dt) for (n, c) in shapes for dt in (torch.bfloat16, torch.float32)]
    cases += [(40, 24, torch.float32), (40, 24, torch.bfloat16), (1001, 64, torch.bfloat16),
              (333, 3, torch.float32)]
    for n, c, dt in cases:
        x = (torch.randn(n, c, device=dev, generator=gen) * 2 + 1).to(dt)
        got = ss.stat_sums(x)
        again = ss.stat_sums(x)
        ref = ss.stat_sums_plain(x)
        xg = x.clone().requires_grad_()
        xr = x.clone().requires_grad_()
        cot = torch.randn(2, c, device=dev, generator=gen)
        s, sq = ss.stat_sums(xg)
        ((s * cot[0]).sum() + (sq * cot[1]).sum()).backward()
        rs, rsq = ss.stat_sums_plain(xr)
        ((rs * cot[0]).sum() + (rsq * cot[1]).sum()).backward()
        torch.cuda.synchronize()
        stats = [normwise_err(g, r) for g, r in zip(got, ref)]
        gerr = normwise_err(xg.grad, xr.grad)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = max(e[1] for e in stats) <= 1e-5 and gerr[1] <= 1e-5 and same
        print(f"stat_sums ({n}, {c}) {str(dt)[6:]}: normwise err sum {stats[0][1]:.3g} "
              f"sumsq {stats[1][1]:.3g} grad {gerr[1]:.3g} (tol 1e-5), same bits on a "
              f"second call {same} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"stat_sums ({n}, {c}) {dt} disagrees with stat_sums_plain")
        errs += [e[0] for e in stats]
        if dt != torch.bfloat16 or (n, c) not in shapes:
            continue
        count = shapes[(n, c)]

        def library():
            xf = x.float()
            torch.sum(xf, 0)
            torch.sum(xf ** 2, 0)

        kernel = time_ms(lambda: ss.stat_sums(x), torch, 20, flush)
        plain = time_ms(lambda: ss.stat_sums_plain(x), torch, 10, flush)
        lib = time_ms(library, torch, 10, flush)
        bms, by = bound(n * c * 2 + 2 * c * 4, 3 * n * c / PEAK_F32_FLOPS)
        print(f"stat_sums times ({n}, {c}) bf16 x{count}: kernel {kernel:.4f} ms, plain "
              f"{plain:.4f} ms, library (torch.sum of x and x^2) {lib:.4f} ms, bound "
              f"{bms:.4f} ms ({by}; {100 * bms / kernel:.1f}% of it)")
        totals.update(kernel=count * kernel, plain=count * plain, library=count * lib,
                      bound=count * bms, **{f"bound_{by}": count * bms})
    print(f"stat_sums times, one forward ({sum(shapes.values())} calls): kernel "
          f"{totals['kernel']:.4f} ms, plain {totals['plain']:.4f} ms, library "
          f"{totals['library']:.4f} ms, bound {totals['bound']:.4f} ms "
          f"({100 * totals['bound'] / totals['kernel']:.1f}% of it)")
    return {
        "name": "stat_sums",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/stat_sums.cu",
        "replaces": "multimodal_active_ai_tpu/ops/pallas_bn.py:52",
        "max_abs_err": max(errs),
        "ms": totals["kernel"],
        "plain_ms": totals["plain"],
        "bound_ms": totals["bound"],
        "bound_by": bound_by(totals),
        "library_ms": totals["library"],
    }


# (identity, relu) of each kind of BatchNorm call (resnet_bn_calls)
BN_KINDS = {"relu": (False, True), "shortcut": (False, False), "residual": (True, True)}


def bn_act_bytes(n: int, c: int, element_size: int, kind: str) -> tuple[int, int]:
    """Least bytes of one fused BatchNorm call, forward and backward: each
    input read once, each output written once (forward x [+ identity] and
    y; backward g, x [+ y for the ReLU's mask] and dx [+ d identity])."""
    identity, relu = BN_KINDS[kind]
    e = n * c * element_size
    return e * (2 + identity), e * (3 + relu + identity)


def check_bn_act(torch, ba):
    """Phase 2, the fused BatchNorm + ReLU (``ops/bn_act.py``; no TPU
    kernel: XLA's fusion of flax BatchNorm): each of its four kernels
    against its plain version on the card at every ``(rows, C)`` of the
    ResNet-50 b=256 train-mode forward (the benchmark cell's), bf16, in each
    kind of call the model makes there, plus float32, the scalar route (C
    not a multiple of the vector; a misaligned input), one row, and a
    clamped variance; the same bits on a second call. Then times of the
    main-path calls, forward and backward: the kernels, the plain
    versions, the library (``F.batch_norm`` with the add and the ReLU, and
    its autograd backward) and the bound (bytes at 3.35 TB/s), each and
    over one ResNet-50 b=256 forward and backward (53 calls each way).

    Tolerances: the statistics, the running update and the gradient sums
    add the same float32 values in another order than the plain versions
    (normwise 1e-5; in the clamped case ``rsqrt`` and the running variance
    on the unclamped half of the channels alone: a variance within rounding
    of 0 is the order's, its sign too); the apply pass
    from the kernel's statistics does the plain version's float32
    operations one by one, each rounded (the same bits); ``dx`` from the
    kernel's sums divides ``db`` and ``dw`` by the rows where torch may
    multiply by the reciprocal (a last-bit step of the per-channel factors:
    normwise 2^-7 in bf16, one bf16 step; 1e-5 in float32) and the
    residual's gradient is the masked ``g`` (the same bits)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev).zero_
    bf16, f32 = torch.bfloat16, torch.float32
    calls = resnet_bn_calls("ResNet50", 256)
    cases = [(n, c, bf16, kind, "") for (n, c, kind) in sorted(calls)]
    cases += [(230400, 64, f32, "relu", ""), (4096, 2048, f32, "residual", ""),
              (40, 24, f32, "residual", ""), (1001, 64, bf16, "relu", ""),
              (333, 3, f32, "residual", ""), (7, 64, bf16, "shortcut", ""),
              (1, 2048, bf16, "relu", ""), (1001, 64, bf16, "residual", "misaligned"),
              (4096, 64, f32, "relu", "clamped")]
    errs, totals = [], Counter()

    def randn(n, c, dt, shift=0.0):
        return (torch.randn(n, c, device=dev, generator=gen) + shift).to(dt)

    for n, c, dt, kind, edge in cases:
        with_id, relu = BN_KINDS[kind]
        if edge == "misaligned":       # a 2-byte offset: the scalar route
            x = torch.randn(n * c + 1, device=dev, generator=gen).to(dt)[1:].view(n, c)
        else:
            x = randn(n, c, dt, torch.linspace(-1, 3, c, device=dev)) * 2
        if edge == "clamped":          # near-constant channels: E[x²] - E[x]² < 0 in float32
            x[:, c // 2:] = 100 + 1e-3 * randn(n, c - c // 2, dt)
        identity = randn(n, c, dt) if with_id else None
        g = randn(n, c, dt)
        w = torch.rand(c, device=dev, generator=gen) + 0.5
        b = torch.randn(c, device=dev, generator=gen)
        rm0 = torch.randn(c, device=dev, generator=gen)
        rv0 = torch.rand(c, device=dev, generator=gen) + 0.5
        runs = []
        for _ in range(2):
            rm, rv = rm0.clone(), rv0.clone()
            nbt = torch.zeros((), dtype=torch.int64, device=dev)
            stats = ba.bn_act_stats(x, rm, rv, nbt, 0.9, 1e-5)
            y = ba.bn_act_apply(x, stats, w, b, identity, relu)
            mask = y if relu else None
            dw, db = ba.bn_act_grad_sums(g, x, mask, stats)
            dx, gy = ba.bn_act_grad_apply(g, x, mask, stats, w, dw, db, True, with_id)
            runs.append([stats, rm, rv, nbt, y, dw, db, dx] + ([gy] if with_id else []))
        torch.cuda.synchronize()
        same = all(torch.equal(u, v) for u, v in zip(*runs))
        stats, rm, rv, nbt, y, dw, db, dx = runs[0][:8]
        mask = y if relu else None
        ref = ba.bn_act_stats_plain(x, 1e-5)
        mean, raw = ba.mean_raw_var(x)
        rm_p, rv_p = rm0.clone(), rv0.clone()
        ba.update_running(rm_p, rv_p, torch.zeros_like(nbt), mean, raw.clamp_min(0.0), 0.9)
        dw_p, db_p = ba.bn_act_grad_sums_plain(g, x, mask, stats)
        dx_p, gy_p = ba.bn_act_grad_apply_plain(g, x, mask, stats, w, dw, db)
        e = {"mean": normwise_err(stats[0], ref[0]), "running_mean": normwise_err(rm, rm_p),
             "dw": normwise_err(dw, dw_p), "db": normwise_err(db, db_p),
             "dx": normwise_err(dx, dx_p)}
        kept = slice(0, c // 2) if edge == "clamped" else slice(None)
        e["rstd"] = normwise_err(stats[1, kept], ref[1, kept])
        e["running_var"] = normwise_err(rv[kept], rv_p[kept])
        exact = {"y": torch.equal(y, ba.bn_act_apply_plain(x, stats, w, b, identity, relu)),
                 "batches": int(nbt) == 1}
        if with_id:
            exact["d_identity"] = torch.equal(runs[0][8], gy_p)
        if edge == "clamped":
            flags = stats[2] != 0
            exact["clamped"] = bool(flags[c // 2:].any()) and not bool(flags[:c // 2].any())
        else:
            exact["flags"] = torch.equal(stats[2], ref[2])
        tol_dx = 2 ** -7 if dt == bf16 else 1e-5
        ok = (same and all(exact.values()) and e["dx"][1] <= tol_dx
              and all(v[1] <= 1e-5 for k, v in e.items() if k != "dx"))
        vec = x.data_ptr() % 16 == 0 and c % (16 // x.element_size()) == 0
        plan = ba.bn_act_plan(n, c, x.element_size(), vec, ba.sm_count(0))
        route = "vec16" if vec else "scalar"
        print(f"bn_act ({n}, {c}) {str(dt)[6:]} {kind}{' ' + edge if edge else ''} [{route}, "
              f"{plan.row_blocks}x{plan.tiles_c} blocks]: normwise "
              + ", ".join(f"{k} {v[1]:.2g}" for k, v in e.items())
              + f" (tol 1e-5, dx {tol_dx:.2g}); " + ", ".join(f"{k} {v}" for k, v in exact.items())
              + f"; same bits on a second call {same} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"bn_act ({n}, {c}) {dt} {kind} {edge} disagrees with its plain versions")
        errs += [v[0] for k, v in e.items() if k not in ("dx", "dw", "db")]
        if dt != bf16 or edge or (n, c, kind) not in calls:
            continue

        # times of a main-path call: kernels, plain versions, library, bound
        count = calls[(n, c, kind)]
        side = math.isqrt(n // 256)
        nchw = lambda t: t.view(256, side, side, c).permute(0, 3, 1, 2)   # noqa: E731
        x4, g4, id4 = nchw(x), nchw(g), None if identity is None else nchw(identity)

        def fwd():
            st = ba.bn_act_stats(x, rm, rv, nbt, 0.9, 1e-5)
            ba.bn_act_apply(x, st, w, b, identity, relu)

        def bwd():
            dw_, db_ = ba.bn_act_grad_sums(g, x, mask, stats)
            ba.bn_act_grad_apply(g, x, mask, stats, w, dw_, db_, True, with_id)

        def plain():
            st = ba.bn_act_stats_plain(x, 1e-5)
            yp = ba.bn_act_apply_plain(x, st, w, b, identity, relu)
            ba.bn_act_grad_plain(g, x, yp if relu else None, st, w)

        xr = x4.detach().requires_grad_()
        wr, br = w.clone().requires_grad_(), b.clone().requires_grad_()

        def library_fwd():
            out = F.batch_norm(xr, rm, rv, wr, br, training=True, momentum=0.1, eps=1e-5)
            out = out if id4 is None else out + id4
            return torch.relu(out) if relu else out

        def library():
            library_fwd().backward(g4)

        k_f, k_b = time_ms(fwd, torch, 20, flush), time_ms(bwd, torch, 20, flush)
        p_ms = time_ms(plain, torch, 5, flush)
        l_f, l_ms = time_ms(library_fwd, torch, 10, flush), time_ms(library, torch, 10, flush)
        f_bytes, b_bytes = bn_act_bytes(n, c, 2, kind)
        bf_ms, bb_ms = (bound(f_bytes, 0.0)[0], bound(b_bytes, 0.0)[0])
        print(f"bn_act times ({n}, {c}) bf16 {kind} x{count}: kernels forward {k_f:.4f} ms "
              f"(bound {bf_ms:.4f}, {100 * bf_ms / k_f:.1f}% of it), backward {k_b:.4f} ms "
              f"(bound {bb_ms:.4f}, {100 * bb_ms / k_b:.1f}%); plain forward + backward "
              f"{p_ms:.4f} ms; library (F.batch_norm{' + add' if with_id else ''}"
              f"{' + relu' if relu else ''}) forward {l_f:.4f} ms, forward + backward "
              f"{l_ms:.4f} ms")
        totals.update(kernel=count * (k_f + k_b), forward=count * k_f, backward=count * k_b,
                      plain=count * p_ms, library=count * l_ms, bound=count * (bf_ms + bb_ms))
    print(f"bn_act times, one ResNet-50 b=256 forward + backward ({sum(calls.values())} calls "
          f"each way): kernels {totals['kernel']:.3f} ms (forward {totals['forward']:.3f}, "
          f"backward {totals['backward']:.3f}), plain {totals['plain']:.3f} ms, library "
          f"{totals['library']:.3f} ms, bound {totals['bound']:.3f} ms "
          f"({100 * totals['bound'] / totals['kernel']:.1f}% of it)")
    return {
        "name": "bn_act",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/bn_act.cu",
        "replaces": "none (XLA fuses flax BatchNorm: multimodal_active_ai_tpu/models/norm.py)",
        "max_abs_err": max(errs),
        "ms": totals["kernel"],
        "plain_ms": totals["plain"],
        "bound_ms": totals["bound"],
        "bound_by": "bytes",
        "library_ms": totals["library"],
    }


def check_conv1x1_stats(torch, cs, sms):
    """Phase 2, B3: ``conv1x1_stats`` at the 15 distinct ``(M, K, N)`` of
    ResNet-50's 36 fused 1x1 convs per forward at b=128 (bf16), float32 at
    two of them, and the tails (96, 24, 40), (64, 16, 64), (100, 12, 7) and,
    in bf16, (1000, 64, 200) (M and N not multiples of the tile), against
    ``conv1x1_stats_plain``; gradients with nonzero cotangents on y, Σy and
    Σy² against autograd through the plain version; times (bf16) per shape
    and summed over one forward. Each case prints its route
    (``conv1x1_plan`` on this card's ``sms``); a main-path shape off the
    wgmma route is fatal.

    Tolerances, normwise (max error over the largest reference value): y
    in bf16 2^-7 (the two float32 products may round to neighbouring bf16
    values: one step is 2^-8 of the value), float32 1e-5; Σy and Σy² 1e-4
    (float32 sums in other orders); gradients 2e-2 in bf16 (the shared
    backward rounds dy + dΣ + 2y·dΣ² to bf16 and uses the rounded y, the
    autograd reference does neither), 1e-4 in float32."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev).zero_
    _, shapes = resnet50_fused_shapes(BATCH)
    assert len(shapes) == 15 and sum(shapes.values()) == 36, shapes
    cases = [(mkn, torch.bfloat16) for mkn in shapes]
    cases += [((28800, 512, 128), torch.float32), ((2048, 1024, 2048), torch.float32)]
    cases += [(mkn, dt) for mkn in ((96, 24, 40), (64, 16, 64), (100, 12, 7))
              for dt in (torch.bfloat16, torch.float32)]
    cases += [((1000, 64, 200), torch.bfloat16)]
    errs, totals = [], Counter()
    for (m, k, n), dt in cases:
        bf16 = dt == torch.bfloat16
        route = cs.conv1x1_plan(m, k, n, sms, bf16).route
        if bf16 and (m, k, n) in shapes and route != "wgmma":
            fail(f"conv1x1_stats main-path shape {(m, k, n)} takes the {route} route")
        x = torch.relu(torch.randn(m, k, device=dev, generator=gen)).to(dt)
        w = (torch.randn(n, k, device=dev, generator=gen) * (2.0 / k) ** 0.5).to(dt)
        got = cs.conv1x1_stats(x, w)
        again = cs.conv1x1_stats(x, w)
        ref = cs.conv1x1_stats_plain(x, w)
        cot = [torch.randn(m, n, device=dev, generator=gen).to(dt),
               torch.randn(n, device=dev, generator=gen),
               torch.randn(n, device=dev, generator=gen) / m ** 0.5]
        grads = []
        for fn in (cs.conv1x1_stats, cs.conv1x1_stats_plain):
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            outs = fn(xg, wg)
            sum((o.float() * c.float()).sum() for o, c in zip(outs, cot)).backward()
            grads.append((xg.grad, wg.grad))
        torch.cuda.synchronize()
        yerr = normwise_err(got[0], ref[0])
        serr = [normwise_err(g, r) for g, r in zip(got[1:], ref[1:])]
        gerr = [normwise_err(g, r) for g, r in zip(*grads)]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ytol, gtol = (2**-7, 2e-2) if bf16 else (1e-5, 1e-4)
        ok = (yerr[1] <= ytol and max(e[1] for e in serr) <= 1e-4
              and max(e[1] for e in gerr) <= gtol and same
              and all(bool(torch.isfinite(t).all()) for t in got))
        print(f"conv1x1_stats ({m}, {k}, {n}) {str(dt)[6:]} [{route}]: normwise err y {yerr[1]:.3g} "
              f"(tol {ytol:.3g}), sum {serr[0][1]:.3g} sumsq {serr[1][1]:.3g} (tol 1e-4), "
              f"grad x {gerr[0][1]:.3g} w {gerr[1][1]:.3g} (tol {gtol:.3g}), same bits on "
              f"a second call {same} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"conv1x1_stats ({m}, {k}, {n}) {dt} disagrees with conv1x1_stats_plain")
        errs += [yerr[0]] + [e[0] for e in serr]
        if not bf16 or (m, k, n) not in shapes:
            continue
        count = shapes[(m, k, n)]
        kernel = time_ms(lambda: cs.conv1x1_stats(x, w), torch, 20, flush)
        plain = time_ms(lambda: cs.conv1x1_stats_plain(x, w), torch, 5, flush)
        lib = time_ms(lambda: torch.matmul(x, w.t()), torch, 20, flush)
        bms, by = bound((m * k + n * k + m * n) * 2 + 2 * n * 4,
                        2 * m * n * k / PEAK_BF16_TENSOR_FLOPS + 3 * m * n / PEAK_F32_FLOPS)
        print(f"conv1x1_stats times ({m}, {k}, {n}) bf16 x{count} [{route}]: kernel "
              f"{kernel:.4f} ms, plain {plain:.4f} ms, library (torch.matmul bf16, no "
              f"statistics) {lib:.4f} ms, bound {bms:.4f} ms ({by}; {100 * bms / kernel:.1f}% "
              f"of it)")
        totals.update(kernel=count * kernel, plain=count * plain, library=count * lib,
                      bound=count * bms, **{f"bound_{by}": count * bms})
    print(f"conv1x1_stats times, one forward (36 calls): kernel {totals['kernel']:.4f} ms, "
          f"plain {totals['plain']:.4f} ms, library {totals['library']:.4f} ms, bound "
          f"{totals['bound']:.4f} ms ({totals['bound_bytes']:.4f} of it bound by bytes, "
          f"{totals['bound_operations']:.4f} by operations; "
          f"{100 * totals['bound'] / totals['kernel']:.1f}% of the kernel time)")
    return {
        "name": "conv1x1_stats",
        "route": "cuda",
        "source": f"{PACKAGE}/csrc/conv1x1_stats.cu",
        "replaces": "multimodal_active_ai_tpu/ops/pallas_conv_bn.py:65",
        "max_abs_err": max(errs),
        "ms": totals["kernel"],
        "plain_ms": totals["plain"],
        "bound_ms": totals["bound"],
        "bound_by": bound_by(totals),
        "library_ms": totals["library"],
    }


def _card_sampler(torch, gs):
    """B1 on the card for a step on the CPU: the sampler's arguments go to
    the card and its glimpses come back, so that a CPU step samples as the
    card step does (the plain sampler rounds the y weights to bf16, the
    kernel keeps them float32)."""
    def sample(mips, rel_y, rel_x, start, scale, wins, msizes=None):
        def card(t):
            return t.cuda().contiguous()
        return gs.glimpse_sample([card(m) for m in mips], card(rel_y), card(rel_x),
                                 card(start), card(scale), wins, msizes).cpu()
    return sample


def _small_step_losses(torch, retina, dev, arch, f=2, sampler=None, **kinds):
    """Per-fixation losses of one small float32 train step (b=8, F=f,
    canvas 64) on ``dev``, from seeded weights, images and draws that do not
    depend on the device or the model's kinds; ``sampler``, if given,
    stands in for the retina's glimpse sampler during the step."""
    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
    from multimodal_active_ai_tpu_torch.train import optimizers, schedule, simclr_train

    cfg = retina.RetinaConfig(canvas_size=64, crop_sizes=(40, 24, 10, 30))
    b = 8
    gen = torch.Generator().manual_seed(3)
    images = torch.randint(0, 256, (b, 64, 64, 3), dtype=torch.uint8, generator=gen)
    params = [retina.sample_unlabeled_params(gen, b, 64, cfg) for _ in range(f + 1)]
    noise = [torch.randn(b, 30, 30, 12, generator=gen) for _ in range(f + 1)]
    model = SimCLRModule(arch, generator=torch.Generator().manual_seed(0), **kinds).to(dev)
    state = simclr_train.TrainState(
        model, optimizers.get_optimizer("adam", model.parameters()),
        schedule.simclr_learning_rate(0.01, b, 64, b, 0, 5))
    step = simclr_train.make_train_step(cfg, f, 0.05)
    kept = retina.glimpse_sample
    retina.glimpse_sample = sampler or kept
    try:
        return step(state, images.to(dev),
                    params=[retina.AugParams(*[x.to(dev) for x in p]) for p in params],
                    noise=[n.to(dev) for n in noise]).cpu()
    finally:
        retina.glimpse_sample = kept


def check_small_step(torch, retina, gs):
    """Phase 2b: small float32 train steps on the card (CUDA kernels)
    against the same steps on the CPU (plain versions; the path the CPU
    tests hold against the JAX package), from equal weights, images and
    draws (b=8, F=2, canvas 64); tolerance 1e-2 relative on the
    per-fixation losses.

    ResNet10: the CPU step samples with the plain version, whose y weights
    are rounded to bf16 where the B1 kernel keeps them float32 (glimpse
    elements differ by up to 2^-9 relative; NT-Xent at T=0.05 amplifies
    projection differences ~20x). ResNet-50 with ``norm_kind='bn_fused'``
    and ``stat_fusion='pallas'`` (B2, B3): that difference moves its loss by
    a few percent, so its CPU step takes its glimpses from the B1 kernel
    (:func:`_card_sampler`) and both sides see the same glimpses up to the
    pyramids' bf16 rounding, leaving B2 and B3 against their plain versions.

    Then the same ResNet-50 step on the card without fusion (norm 'bn',
    cuDNN 1x1 convs, ``.mean()`` statistics) must match the fused one to
    5e-3 (on the CPU the two agree to 2e-6 on the first loss and 7e-4 on
    the second, after one Adam step)."""
    fused = dict(norm_kind="bn_fused", stat_fusion="pallas")
    for arch, kinds, sampler in [("ResNet10", {}, None),
                                 ("ResNet50", fused, _card_sampler(torch, gs))]:
        losses = {"cpu": _small_step_losses(torch, retina, "cpu", arch, 2, sampler, **kinds),
                  "cuda": _small_step_losses(torch, retina, "cuda", arch, 2, **kinds)}
        ok = bool(torch.allclose(losses["cuda"], losses["cpu"], rtol=1e-2, atol=0.0))
        glimpses = "the card's glimpses on both sides" if sampler else "plain sampler on the cpu"
        print(f"small f32 train step ({arch} {kinds or ''}, b=8, F=2, canvas 64; {glimpses}): "
              f"cuda losses {losses['cuda'].tolist()} vs cpu {losses['cpu'].tolist()} "
              f"(rtol=1e-2) {'ok' if ok else 'MISMATCH'}")
        if not ok or not bool(torch.isfinite(losses["cuda"]).all()):
            fail(f"the {arch} train step on the card disagrees with the CPU step")
    on_card = [_small_step_losses(torch, retina, "cuda", "ResNet50", 2, **k) for k in (fused, {})]
    ok = bool(torch.allclose(on_card[0], on_card[1], rtol=5e-3, atol=0.0))
    print(f"small f32 train step (ResNet50, b=8, F=2, canvas 64) on the card: bn_fused + "
          f"pallas {on_card[0].tolist()} vs unfused bn {on_card[1].tolist()} (rtol=5e-3) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("the fused ResNet50 step disagrees with the unfused one on the card")


def check_odd_rows(torch, counters):
    """Phase 2c: ResNet-50 encoder features in train mode at b=1, where the
    1x1 convs have N·H·W = 900, 225, 64 and 16 rows (the first two not
    multiples of 8). With ``norm_kind='bn_fused'`` and
    ``stat_fusion='pallas'`` each of the 36 fused convs launches B3 and
    each of the 17 other norms B2, and the ``bn`` model with the same
    weights runs each of its 53 norms as ``bn_act``'s statistics and apply
    kernels, with the counters set to 0 just before and read just after;
    the float32 features of the two match (cuDNN convs and the fused
    norms on the ``bn`` side) to normwise 1e-3 (BatchNorm over layer4's 16 pixels amplifies roundings:
    on the CPU the two models' plain paths differ by 2.7e-5)."""
    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule

    b2, b3 = resnet50_fused_shapes(1)
    rows = sorted({m for m, _, _ in b3}, reverse=True)
    none = dict.fromkeys(counters, 0)
    want = [{**none, "stat_sums": sum(b2.values()), "conv1x1_stats": sum(b3.values())},
            {**none, **bn_act_launches(1, 0, 53)}]
    dev = torch.device("cuda")
    x = torch.rand(1, 30, 30, 12, generator=torch.Generator().manual_seed(4)).to(dev)
    models = [SimCLRModule(ARCH, norm_kind=n, stat_fusion=f,
                           generator=torch.Generator().manual_seed(0))
              for n, f in (("bn_fused", "pallas"), ("bn", None))]
    models[1].load_state_dict(models[0].state_dict())
    feats = []
    for model in models:
        model = model.to(dev).to(memory_format=torch.channels_last)
        reset_counts(counters.values())
        with torch.no_grad():
            feats.append(model.features(x))
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items()}
        if got != want[len(feats) - 1]:
            fail(f"b=1 forward {len(feats)} of (bn_fused + pallas, bn) launches {got}, "
                 f"expected {want[len(feats) - 1]}")
    _, rel = normwise_err(feats[0], feats[1])
    ok = rel <= 1e-3 and bool(torch.isfinite(feats[0]).all())
    print(f"b=1 forwards (1x1 conv rows {rows}): launches bn_fused + pallas {want[0]}, bn "
          f"{want[1]}; bn_fused + pallas features "
          f"vs unfused bn normwise err {rel:.3g} (tol 1e-3) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("the b=1 fused ResNet50 features disagree with the unfused ones")


TRAIN_STEPS = min(math.ceil(EXAMPLES / BATCH), 12)
EVAL_STEPS = min(math.ceil(max(EXAMPLES // 10, BATCH) / BATCH), 12)


def reset_counts(kernels) -> None:
    for k in kernels:
        k.launches = 0


def median_step_ms(torch, step, label, device_name, fixations, peak_gib=None,
                   steps=3, what=None, batch=BATCH) -> float:
    """Median host time of ``steps`` synchronised calls of ``step()``
    (bf16, ResNet-50 b=128, canvas 640, unless ``what`` says otherwise),
    printed with ``batch`` samples a step per second."""
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = sorted(times)[steps // 2]
    mem = "" if peak_gib is None else f"; peak memory {peak_gib:.2f} GiB"
    what = what or f"{ARCH}, b={BATCH}, F={fixations}, canvas {CANVAS}, bf16"
    print(f"train step {label} ({what}): "
          f"median {med:.1f} ms over {steps} steps {[round(t, 1) for t in times]}, "
          f"{batch / med * 1e3:.1f} samples/s{mem} [{device_name}]")
    return med


def step_times(torch, state, label, device_name, peak_gib=None) -> float:
    """Median host time of 3 synchronised SimCLR train steps on ``state``
    (F=10); fails on non-finite losses."""
    from multimodal_active_ai_tpu_torch.ops import retina
    from multimodal_active_ai_tpu_torch.train import simclr_train
    step = simclr_train.make_train_step(retina.RetinaConfig(canvas_size=CANVAS), FIXATIONS, 0.05)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    images = torch.randint(0, 256, (BATCH, CANVAS, CANVAS, 3), generator=gen,
                           dtype=torch.uint8, device=dev)

    def checked():
        losses = step(state, images, gen)
        if not bool(torch.isfinite(losses).all()):
            fail(f"non-finite losses {losses.tolist()}")

    return median_step_ms(torch, checked, label, device_name, FIXATIONS, peak_gib)


def drive_and_check(torch, driver, ckpt_mod, argv, ckdir, label):
    """One driver run (3 train steps + validation) and its resume, checked;
    returns the trained state and the wall time of the first run."""
    t0 = time.perf_counter()
    state = driver.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ck = os.path.join(ckdir, "checkpoint.pth.tar")
    if not os.path.isfile(ck):
        fail(f"contrastive_learning {label} wrote no checkpoint")
    payload = ckpt_mod.load_checkpoint(ck)
    hist = payload["loss_history"]
    if not hist or not all(math.isfinite(x) for x in hist):
        fail(f"non-finite loss history {hist}")
    if payload["step"] != TRAIN_STEPS * FIXATIONS or state.step != payload["step"]:
        fail(f"optimizer updates {state.step}/{payload['step']}, "
             f"expected {TRAIN_STEPS * FIXATIONS}")
    print(f"checkpoint {label} {os.path.basename(ck)}: epoch {payload['epoch']}, "
          f"step {payload['step']}, loss_history {hist}")
    return state, payload, ck, wall


def run_main_path(torch, counters, driver, ckpt_mod, device_name, ckdir):
    """Phase 3: the SimCLR driver at full ResNet-50 width, then a resume.
    Its checkpoint stays in ``ckdir`` for the probe and DETR phases. Each
    train step runs the 53 BatchNorms as ``bn_act`` in 1+F forwards and F
    backwards (583 and 530 launches at F=10), an eval step none (eval
    mode); B2-B4 are off this path. Returns the B1 launches, the bn_act
    launches, the median step and the checkpoint."""
    argv = ["--dataset", "synthetic", "--arch", ARCH, "-b", str(BATCH),
            "-f", str(FIXATIONS), "--canvas-size", str(CANVAS),
            "--epochs", "1", "-t", "--num-examples", str(EXAMPLES),
            "--checkpoint-dir", ckdir, "-p", "1"]
    train_steps, eval_steps = TRAIN_STEPS, EVAL_STEPS
    want = {**dict.fromkeys(counters, 0),
            "glimpse_sample": train_steps * (1 + FIXATIONS) + 2 * eval_steps,
            **bn_act_launches(train_steps * (1 + FIXATIONS), train_steps * FIXATIONS, 53)}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters.values())
    state, payload, ck, wall = drive_and_check(torch, driver, ckpt_mod, argv, ckdir, "")
    got = {k: c.launches for k, c in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"main path: {train_steps} train steps x (1+{FIXATIONS}) views + "
          f"{eval_steps} eval step(s); launches {got} (expected {want}); "
          f"wall {wall:.2f} s incl. first-call set-up")
    if got != want:
        fail(f"main path launches {got}, expected {want}")

    resumed = driver.main(argv + ["--resume", ck])
    saved, restored = payload["state_dict"], resumed.model.state_dict()
    same = all(torch.equal(restored[k].cpu(), saved[k].cpu()) for k in saved)
    if resumed.step != payload["step"] or not same:
        fail("resume did not restore the checkpoint")
    print(f"resume: restored step {resumed.step} and all "
          f"{len(saved)} state_dict tensors")

    # steady-state step time on the trained state (host clock around a
    # synchronised step; the launch count above is already read)
    step_ms = step_times(torch, state, "bn", device_name, peak_gib)
    return (got["glimpse_sample"], {k: got[k] for k in BN_ACT_KERNELS}, step_ms, ck)


def drive_downstream(torch, counters, driver, argv, ckdir, ckpt_name, label):
    """One downstream driver run (train steps + validation from the SimCLR
    checkpoint), its launch counts (B1 once a train and an eval step, no
    B2, B3 or B4, and no bn_act: the probe's encoder runs in eval mode,
    DETR's backbone has frozen BatchNorm) and its resume, checked. Returns
    the state, the checkpoint payload, the B1 launches and the peak memory
    in GiB."""
    from multimodal_active_ai_tpu_torch.utils import checkpoint
    want = {**dict.fromkeys(counters, 0), "glimpse_sample": TRAIN_STEPS + EVAL_STEPS}
    gc.collect()
    torch.cuda.synchronize()
    held_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters.values())
    t0 = time.perf_counter()
    state = driver.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: c.launches for k, c in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label} path: {TRAIN_STEPS} train + {EVAL_STEPS} eval steps; launches {got} "
          f"(expected {want}); wall {wall:.2f} s incl. first-call set-up; peak memory "
          f"{peak_gib:.2f} GiB, {held_gib:.2f} GiB of it held before the run")
    if got != want:
        fail(f"{label} launches {got}, expected {want}")
    if state.step != TRAIN_STEPS:
        fail(f"{label} took {state.step} updates, expected {TRAIN_STEPS}")
    ck = os.path.join(ckdir, ckpt_name)
    if not os.path.isfile(ck):
        fail(f"{label} wrote no {ckpt_name}")
    payload = checkpoint.load_checkpoint(ck, "cuda")
    if sorted(payload) != ["best_prec1", "epoch", "optimizer", "state_dict"]:
        fail(f"{label} checkpoint keys {sorted(payload)}")
    if not all(bool(torch.isfinite(v).all()) for v in payload["state_dict"].values()):
        fail(f"{label} checkpoint holds non-finite weights")
    resumed = driver.main(argv + ["--resume", ck])
    sd, opt = resumed.model.state_dict(), resumed.optimizer.state_dict()["state"]
    same = all(torch.equal(sd[k], v) for k, v in payload["state_dict"].items()) and all(
        torch.equal(opt[i][k], v) for i, st in payload["optimizer"]["state"].items()
        for k, v in st.items())
    if resumed.step != TRAIN_STEPS or not same:
        fail(f"{label} resume did not restore the checkpoint")
    print(f"resume {label}: restored step {resumed.step}, all {len(sd)} state_dict tensors "
          f"and the optimizer state of {len(opt)} parameters")
    return state, payload, got["glimpse_sample"], peak_gib


def run_probe_path(torch, counters, simclr_ck, workdir, device_name):
    """Phase 3c: the linear-probe driver from the phase-3 SimCLR checkpoint
    (ResNet-50 encoder frozen in eval mode, b=128, F=2, canvas 640, bf16),
    its resume, and the median probe train step."""
    from multimodal_active_ai_tpu_torch import representation_evaluation as probe_driver
    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
    from multimodal_active_ai_tpu_torch.ops import retina
    from multimodal_active_ai_tpu_torch.train import eval_probe

    ckdir = os.path.join(workdir, "probe")
    argv = [simclr_ck, "--dataset", "synthetic", "--arch", ARCH, "-b", str(BATCH),
            "-f", str(PROBE_FIXATIONS), "--canvas-size", str(CANVAS), "--epochs", "1", "-t",
            "--num-examples", str(EXAMPLES), "--checkpoint-dir", ckdir, "-p", "1"]
    state, _, launches, peak = drive_downstream(
        torch, counters, probe_driver, argv, ckdir, "classifier_checkpoint.pth.tar", "probe")
    dev = torch.device("cuda")
    encoder = SimCLRModule(ARCH, dtype=torch.bfloat16).to(dev).to(memory_format=torch.channels_last)
    if not probe_driver.load_pretrained_encoder(encoder, simclr_ck, dev):
        fail("the probe's encoder did not load the SimCLR checkpoint")
    step = eval_probe.make_probe_train_step(retina.RetinaConfig(canvas_size=CANVAS),
                                            PROBE_FIXATIONS)
    gen = torch.Generator(device=dev).manual_seed(7)
    images = torch.randint(0, 256, (BATCH, CANVAS, CANVAS, 3), generator=gen,
                           dtype=torch.uint8, device=dev)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    ms = median_step_ms(torch, lambda: step(state, encoder, images, labels, gen), "probe",
                        device_name, PROBE_FIXATIONS, peak, steps=9)
    return launches, ms


def run_detr_path(torch, counters, simclr_ck, workdir, device_name):
    """Phase 3d: the DETR driver with its default model (6 + 6 layers,
    hidden 256, 8 heads, FFN 2048, 10 queries, 1000 classes) on the
    ResNet-50 backbone from the phase-3 SimCLR checkpoint, its resume, the
    frozen stem and layer1 unchanged, ``aux_logits`` of shape (5, B, 10,
    1000), and the median DETR train step."""
    from multimodal_active_ai_tpu_torch import detr_image_classification as detr_driver
    from multimodal_active_ai_tpu_torch.objectives.set_criterion import SetCriterion
    from multimodal_active_ai_tpu_torch.ops import retina
    from multimodal_active_ai_tpu_torch.train import detr_train
    from multimodal_active_ai_tpu_torch.utils import checkpoint

    ckdir = os.path.join(workdir, "detr")
    argv = [simclr_ck, "--dataset", "synthetic", "--backbone", ARCH, "-b", str(BATCH),
            "-f", str(PROBE_FIXATIONS), "--canvas-size", str(CANVAS), "--epochs", "1", "-t",
            "--num-examples", str(EXAMPLES), "--checkpoint-dir", ckdir, "-p", "1"]
    state, payload, launches, peak = drive_downstream(
        torch, counters, detr_driver, argv, ckdir, "detr_classifier_checkpoint.pth.tar", "DETR")
    model = state.model
    simclr = checkpoint.load_checkpoint(simclr_ck, "cuda")["state_dict"]
    labels = detr_train.detr_param_labels(model)
    frozen = [n for n, lab in labels.items() if lab == "frozen"]
    body = "backbone.0.body."
    if not frozen or not all(torch.equal(payload["state_dict"][n], simclr["f." + n[len(body):]])
                             for n in frozen):
        fail("a frozen DETR parameter changed")
    moved = [n for n, lab in labels.items() if lab == "backbone"
             and not torch.equal(payload["state_dict"][n], simclr["f." + n[len(body):]])]
    print(f"DETR: {len(frozen)} frozen parameters unchanged, {len(moved)} of "
          f"{sum(lab == 'backbone' for lab in labels.values())} backbone parameters moved")

    cfg = retina.RetinaConfig(canvas_size=CANVAS)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    images = torch.randint(0, 256, (BATCH, CANVAS, CANVAS, 3), generator=gen,
                           dtype=torch.uint8, device=dev)
    targets = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    glimpses, sacc, mask = detr_train.collect_glimpse_sequence(images, cfg, PROBE_FIXATIONS, gen)
    model.eval()
    with torch.no_grad():
        out = model(glimpses, sacc, mask)
    want = (5, BATCH, 10, 1000)
    if tuple(out["aux_logits"].shape) != want or not bool(torch.isfinite(out["aux_logits"]).all()):
        fail(f"aux_logits {tuple(out['aux_logits'].shape)}, expected finite {want}")
    print(f"DETR forward: pred_logits {tuple(out['pred_logits'].shape)}, aux_logits "
          f"{tuple(out['aux_logits'].shape)}, finite")
    step = detr_train.make_detr_train_step(SetCriterion(10, 1000), cfg, PROBE_FIXATIONS, 0.1)
    drop = torch.Generator(device=dev).manual_seed(11)
    ms = median_step_ms(torch, lambda: step(state, images, targets, gen, dropout_generator=drop),
                        "DETR", device_name, PROBE_FIXATIONS, peak, steps=9)
    return launches, ms


def expected_dqn_updates(seed: int, steps: int, batch: int, capacity: int, dqnb: int) -> int:
    """The DQN updates of an RLS driver run: the ``RandomState(seed)`` coin
    < 0.7, drawn only once the replay memory holds ``dqnb`` transitions (one
    pushed per sample and step)."""
    import numpy as np
    rs, size, n = np.random.RandomState(seed), 0, 0
    for _ in range(steps):
        size = min(size + batch, capacity)
        n += size >= dqnb and rs.uniform() < 0.7
    return n


def run_rls_path(torch, counters, simclr_ck, workdir, device_name):
    """Phase 3e: the RLS driver from the phase-3 SimCLR checkpoint (DETR's
    default model on ResNet-50, ResNet18 DQN, A = 100, -dqnb 256, capacity
    10,000, b=128, F=2, canvas 640, bf16; target synced every epoch):
    launches, DQN updates, the three checkpoints, target = policy; its
    resume to epoch 2 with the policy in the loop, every tensor restored;
    the median RLS train step and DQN update. Returns the B1 launches, the
    two medians and the peak memory."""
    import copy
    from multimodal_active_ai_tpu_torch import detr_image_classification_rls as rls_driver
    from multimodal_active_ai_tpu_torch.objectives.set_criterion import SetCriterion
    from multimodal_active_ai_tpu_torch.ops import retina
    from multimodal_active_ai_tpu_torch.rl.replay_memory import ReplayMemory
    from multimodal_active_ai_tpu_torch.train import rls_train
    from multimodal_active_ai_tpu_torch.utils import checkpoint

    f = PROBE_FIXATIONS
    ckdir = os.path.join(workdir, "rls")
    argv = [simclr_ck, "--dataset", "synthetic", "--backbone", ARCH, "-b", str(BATCH),
            "-f", str(f), "--canvas-size", str(CANVAS), "--epochs", "1", "-t",
            "--num-examples", str(EXAMPLES), "--checkpoint-dir", ckdir, "-p", "1",
            "--target-update-freq", "1"]
    updates = expected_dqn_updates(15, TRAIN_STEPS, BATCH, 10_000, 256)
    # bn_act: the DQN's 20 BatchNorms in each update's train-mode forward
    # and backward (its rollout forwards run in eval mode; DETR's are frozen)
    dqn_norms = sum(resnet_bn_calls("ResNet18", 1).values())
    want = {**dict.fromkeys(counters, 0),
            "glimpse_sample": TRAIN_STEPS * f + EVAL_STEPS * 2 * f,
            **bn_act_launches(updates, updates, dqn_norms)}
    names = {n: os.path.join(ckdir, n) for n in (
        "detr_classifier_checkpoint.pth.tar", "detr_classifier_model_best.pth.tar",
        "dqn_checkpoint.pth.tar")}

    def run(extra, label, epoch, dqn_step):
        reset_counts(counters.values())
        t0 = time.perf_counter()
        state, pstate = rls_driver.main(argv + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: c.launches for k, c in counters.items()}
        print(f"RLS {label}: {TRAIN_STEPS} train + {EVAL_STEPS} eval steps (F={f}); launches "
              f"{got} (expected {want}); DQN updates to step {pstate.step} (expected "
              f"{dqn_step}: {updates} a run from RandomState(15)'s coins); wall {wall:.2f} s")
        if got != want:
            fail(f"RLS {label} launches {got}, expected {want}")
        if pstate.step != dqn_step or state.step != epoch * TRAIN_STEPS:
            fail(f"RLS {label}: DQN step {pstate.step}, DETR step {state.step}")
        detr = checkpoint.load_checkpoint(names["detr_classifier_checkpoint.pth.tar"], "cuda")
        dqn = checkpoint.load_checkpoint(names["dqn_checkpoint.pth.tar"], "cuda")
        if sorted(detr) != ["best_prec1", "epoch", "optimizer", "state_dict"] or sorted(dqn) != [
                "epoch", "policy_state_dict", "step", "target_state_dict"]:
            fail(f"RLS {label} checkpoint keys {sorted(detr)}, {sorted(dqn)}")
        # the best-model copy is written when top-1 beats the best so far (0
        # at the start), as in the JAX driver; at 1000 random classes it may not
        best = os.path.isfile(names["detr_classifier_model_best.pth.tar"])
        if detr["epoch"] != epoch or dqn["epoch"] != epoch or dqn["step"] != dqn_step or (
                detr["best_prec1"] > 0) != best:
            fail(f"RLS {label}: epochs {detr['epoch']}/{dqn['epoch']}, DQN step {dqn['step']}, "
                 f"best_prec1 {detr['best_prec1']}, best file {best}")
        tensors = [*detr["state_dict"].values(), *dqn["policy_state_dict"].values()]
        if not all(bool(torch.isfinite(v.float()).all()) for v in tensors):
            fail(f"RLS {label} checkpoints hold non-finite weights")
        if not all(torch.equal(dqn["target_state_dict"][k], v)
                   for k, v in dqn["policy_state_dict"].items()):
            fail(f"RLS {label}: the synced target differs from the policy")
        print(f"RLS {label} checkpoints: {os.path.basename(names['dqn_checkpoint.pth.tar'])} "
              f"(epoch {dqn['epoch']}, step {dqn['step']}, target = policy, "
              f"{len(dqn['policy_state_dict'])} tensors), detr_classifier_checkpoint.pth.tar "
              f"(epoch {detr['epoch']}), best-model copy "
              f"{'written' if best else 'not written (top-1 0)'}; all finite")
        return state, pstate, detr, dqn

    gc.collect()
    torch.cuda.synchronize()
    held_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    state, pstate, detr, dqn = run([], "run", 1, updates)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # the resume: the first train step of epoch 1 sees every tensor of both
    # checkpoints, and the DQN then takes its own updates
    seen = {}
    make = rls_train.make_rls_train_step

    def spy(*args, **kwargs):
        step = make(*args, **kwargs)

        def first(state, dqn_model, *rest):
            if not seen:
                seen.update(model={k: v.clone() for k, v in state.model.state_dict().items()},
                            opt=copy.deepcopy(state.optimizer.state_dict()),
                            policy={k: v.clone() for k, v in dqn_model.state_dict().items()},
                            step=state.step)
            return step(state, dqn_model, *rest)
        return first

    rls_train.make_rls_train_step = spy
    try:
        run(["--epochs", "2", "--resume", names["detr_classifier_checkpoint.pth.tar"],
             "--dqn-resume", names["dqn_checkpoint.pth.tar"]], "resume", 2, 2 * updates)
    finally:
        rls_train.make_rls_train_step = make
    same = (seen.get("step") == TRAIN_STEPS
            and all(torch.equal(seen["model"][k], v) for k, v in detr["state_dict"].items())
            and all(torch.equal(seen["policy"][k], v) for k, v in dqn["policy_state_dict"].items())
            and all(torch.equal(seen["opt"]["state"][i][k], v)
                    for i, st in detr["optimizer"]["state"].items() for k, v in st.items()))
    if not same:
        fail("the RLS resume did not restore every tensor of its checkpoints")
    print(f"RLS resume: the first step of epoch 1 saw all {len(detr['state_dict'])} DETR "
          f"tensors, the AdamW state of {len(detr['optimizer']['state'])} parameters and all "
          f"{len(dqn['policy_state_dict'])} DQN tensors of the checkpoints")

    # steady state on the trained run: the train step with its replay push
    # (ε coins all 1: after fixation 0 the policy picks, as late in
    # training), then the DQN update on b=256 replay samples
    dev = torch.device("cuda")
    cfg = retina.RetinaConfig(canvas_size=CANVAS)
    gen = torch.Generator(device=dev).manual_seed(9)
    host_gen = torch.Generator().manual_seed(9)
    images = torch.randint(0, 256, (BATCH, CANVAS, CANVAS, 3), generator=gen,
                           dtype=torch.uint8, device=dev)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    step = rls_train.make_rls_train_step(SetCriterion(10, 1000), cfg, f, 100, 0.9, 0.05, 10.0,
                                         0.1)
    memory = ReplayMemory(10_000, (30, 30, 12), seed=15, device=dev)
    policy = pstate.model

    drop = torch.Generator(device=dev).manual_seed(12)

    def train_step():
        draws = rls_train.draw_rollout(gen, host_gen, BATCH, f, drop)._replace(coins=(1.0,) * f)
        m, ro, reward = step(state, policy, images, labels, 1, draws)
        rls_driver.push_rollout(memory, ro, draws.num_fixs, reward, False)
        if not bool(torch.isfinite(m["loss_ce"])):
            fail(f"non-finite RLS loss {float(m['loss_ce'])}")

    rls_ms = median_step_ms(torch, train_step, "RLS (rollout + DETR update + replay push)",
                            device_name, f, peak_gib, steps=9)
    update = rls_train.make_dqn_update_step(100, 0.999)
    target = copy.deepcopy(policy)

    def dqn_step():
        if not math.isfinite(float(update(pstate, target, memory.sample(256)))):
            fail("non-finite DQN loss")

    dqn_ms = median_step_ms(torch, dqn_step, "DQN update", device_name, f, steps=9,
                            what="ResNet18, b=256 replay samples, A=100, bf16", batch=256)
    print(f"RLS peak memory {peak_gib:.2f} GiB in the driver run ({held_gib:.2f} GiB of it "
          f"held before it; the replay ring is 0.86 GB)")
    return want["glimpse_sample"], rls_ms, dqn_ms, peak_gib


def run_caption_path(torch, counters, simclr_ck, workdir, device_name):
    """Phase 3f: the caption-probe driver from the phase-3 SimCLR checkpoint
    (ResNet-50 encoder, float32 as in the JAX driver, frozen in eval mode;
    b=128, F=2, canvas 640; the text tower at its defaults: vocab 32768,
    d 256, 8 heads, 4 layers, FFN 1024, max_len 32, out 128; the image head
    65,536 -> 1024 -> 128), then its resume. Each run: launches (B1 once a
    train and an eval step, B2-B4 never), finite losses and retrieval
    metrics, the encoder unchanged; the resume's first step sees every
    tensor of both towers (Adam fresh). Returns the B1 launches of a run,
    the median caption train step and the peak memory."""
    import contextlib
    import io
    import re
    from multimodal_active_ai_tpu_torch import coco_captions_probe as cap_driver
    from multimodal_active_ai_tpu_torch.config import CaptionProbeConfig, parse_into
    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
    from multimodal_active_ai_tpu_torch.ops import retina
    from multimodal_active_ai_tpu_torch.train import caption_probe
    from multimodal_active_ai_tpu_torch.utils import checkpoint

    f = PROBE_FIXATIONS
    ckdir = os.path.join(workdir, "captions")
    ck = os.path.join(ckdir, "caption_probe_checkpoint.pth.tar")
    argv = [simclr_ck, "--dataset", "synthetic", "-a", ARCH, "-b", str(BATCH), "-f", str(f),
            "--canvas-size", str(CANVAS), "-t", "--epochs", "1", "--checkpoint-dir", ckdir,
            "-p", "1"]
    cfg = parse_into(CaptionProbeConfig, argv)
    batches = math.ceil((cfg.num_examples or 16 * BATCH) / BATCH)
    train_steps, eval_steps = cap_driver.loop_steps(cfg.test, batches)
    want = {**dict.fromkeys(counters, 0), "glimpse_sample": train_steps + eval_steps}
    seen = {}
    make = caption_probe.make_caption_probe_train_step

    def spy(*args, **kwargs):
        step = make(*args, **kwargs)

        def first(state, encoder, *rest, **kw):
            if not seen:
                seen.update(towers={k: v.clone() for k, v in state.model.state_dict().items()},
                            encoder=encoder, step=state.step, opt=len(state.optimizer.state),
                            frozen={k: v.clone() for k, v in encoder.state_dict().items()})
            return step(state, encoder, *rest, **kw)
        return first

    def run(extra, label):
        seen.clear()
        reset_counts(counters.values())
        out = io.StringIO()
        t0 = time.perf_counter()
        caption_probe.make_caption_probe_train_step = spy
        try:
            with contextlib.redirect_stdout(out):
                state, _ = cap_driver.main(argv + extra)
        finally:
            caption_probe.make_caption_probe_train_step = make
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log = out.getvalue()
        got = {k: c.launches for k, c in counters.items()}
        losses = [float(x) for x in re.findall(r"Loss (\S+) ", log)]
        top = {k: float(v) for k, v in re.findall(r"##(\S+ Top-\d) (\S+)", log)}
        print(f"caption {label}: {train_steps} train + {eval_steps} eval steps (F={f}); "
              f"launches {got} (expected {want}); losses {[round(x, 4) for x in losses]}; "
              f"retrieval {top}; wall {wall:.2f} s incl. first-call set-up")
        if got != want:
            fail(f"caption {label} launches {got}, expected {want}")
        if state.step != train_steps or len(losses) != train_steps or not all(
                math.isfinite(x) for x in losses):
            fail(f"caption {label}: {state.step} updates, losses {losses}")
        if sorted(top) != ["I2T Top-1", "I2T Top-5", "T2I Top-1", "T2I Top-5"] or not all(
                0 <= v <= 1 for v in top.values()):
            fail(f"caption {label}: retrieval lines {top}")
        now = seen["encoder"].state_dict()
        if not all(torch.equal(now[k], v) for k, v in seen["frozen"].items()):
            fail(f"caption {label}: the frozen encoder changed")
        payload = checkpoint.load_checkpoint(ck, "cuda")
        if sorted(payload) != ["epoch", "state_dict", "vocab_size"] or payload["epoch"] != 1 \
                or payload["vocab_size"] != cfg.vocab_size:
            fail(f"caption {label} checkpoint {sorted(payload)}, epoch {payload.get('epoch')}")
        if not all(bool(torch.isfinite(v).all()) for v in payload["state_dict"].values()):
            fail(f"caption {label} checkpoint holds non-finite weights")
        return state, payload

    gc.collect()
    torch.cuda.synchronize()
    held_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    state, payload = run([], "run")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    simclr_f = checkpoint.encoder_state_dict(checkpoint.load_checkpoint(simclr_ck, "cuda")[
        "state_dict"])
    enc = seen["encoder"].f.state_dict()
    if not all(torch.equal(enc[k], v) for k, v in simclr_f.items()):
        fail("the caption encoder is not the SimCLR checkpoint's")
    print(f"caption: encoder f = the SimCLR checkpoint's ({len(simclr_f)} tensors) and "
          f"unchanged by training; checkpoint keys {sorted(payload)}, vocab_size "
          f"{payload['vocab_size']}")

    run(["--resume", ck], "resume")
    sd = payload["state_dict"]
    if seen["step"] != 0 or seen["opt"] != 0 or sorted(seen["towers"]) != sorted(sd) or not all(
            torch.equal(seen["towers"][k], v) for k, v in sd.items()):
        fail("the caption resume did not restore every tensor of both towers")
    print(f"caption resume: the first step saw all {len(sd)} tensors of both towers bit for "
          f"bit, vocab_size {payload['vocab_size']}, Adam fresh (step {seen['step']})")

    dev = torch.device("cuda")
    encoder = SimCLRModule(ARCH).to(dev).to(memory_format=torch.channels_last)
    encoder.f.load_state_dict(simclr_f)
    step = caption_probe.make_caption_probe_train_step(retina.RetinaConfig(canvas_size=CANVAS), f,
                                                       cfg.temperature)
    gen = torch.Generator(device=dev).manual_seed(10)
    images = torch.randint(0, 256, (BATCH, CANVAS, CANVAS, 3), generator=gen,
                           dtype=torch.uint8, device=dev)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    tokens = cap_driver.caption_tokens(labels, cfg.vocab_size, cfg.max_len)

    drop = torch.Generator(device=dev).manual_seed(13)

    def train_step():
        m = step(state, encoder, images, tokens, gen, dropout_generator=drop)
        if not math.isfinite(float(m["loss"])):
            fail("non-finite caption loss")

    ms = median_step_ms(torch, train_step, "caption", device_name, f, steps=9,
                        what=f"{ARCH} float32 encoder, b={BATCH}, F={f}, canvas {CANVAS}; "
                             "text tower d 256, 4 layers, vocab 32768, L 32")
    print(f"caption peak memory {peak_gib:.2f} GiB in the driver run ({held_gib:.2f} GiB of it "
          f"held before it) [{device_name}]")
    return want["glimpse_sample"], ms, peak_gib


# phase 3g: image files. An ImageNet-layout folder generated from a seed:
# 421 train images (3 batches of 128 and a padded one of 37) and 128 val
# images in 8 class directories, at sizes about ImageNet's and COCO's
REAL_TRAIN, REAL_VAL, REAL_CLASSES, REAL_SEED = 421, 128, 8, 2024
REAL_SIZES = ((500, 375), (375, 500), (640, 480), (500, 333), (300, 225), (800, 600))
REAL_WORKERS = 4
LOADER_LINE = (r"loader \((\w+)\): (\d+) batches \| produce ([\d.]+) ms/batch \| "
               r"consumer wait ([\d.]+) ms/batch \| (\d+) decoded, (\d+) cache hits")


def write_real_folder(root: str) -> tuple[float, int]:
    """``root/{train,val}/class_c/``: smooth class-hued pictures with noise,
    mostly RGB JPEG at quality 90, 1 in 16 grayscale JPEG, 1 in 32 RGBA PNG;
    returns the folder's MB and its image count."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from PIL import Image

    hues = [np.array(Image.new("HSV", (1, 1), (c * 256 // REAL_CLASSES, 200, 200))
                     .convert("RGB"))[0, 0].astype(np.float32) for c in range(REAL_CLASSES)]
    jobs = [(split, i) for split, n in (("train", REAL_TRAIN), ("val", REAL_VAL))
            for i in range(n)]

    def write(job):
        split, i = job
        rng = np.random.RandomState(REAL_SEED * 100_003 + (split == "val") * 50_000 + i)
        c = i % REAL_CLASSES
        w, h = REAL_SIZES[rng.randint(len(REAL_SIZES))]
        field = Image.fromarray(rng.randint(0, 256, (6, 8, 3), dtype=np.uint8))
        smooth = np.asarray(field.resize((w, h), Image.BICUBIC), np.float32)
        noise = rng.randint(-14, 15, (h, w, 3), dtype=np.int16)
        img = np.clip(0.55 * hues[c] + 0.45 * smooth + noise, 0, 255).astype(np.uint8)
        d = os.path.join(root, split, f"n{c:08d}")
        if i % 32 == 31:
            path = os.path.join(d, f"{split}_{i:05d}.png")
            Image.fromarray(np.dstack([img, img[..., :1]]), "RGBA").save(path)
        elif i % 16 == 15:
            path = os.path.join(d, f"{split}_{i:05d}.JPEG")
            Image.fromarray(img).convert("L").save(path, "JPEG", quality=90)
        else:
            path = os.path.join(d, f"{split}_{i:05d}.JPEG")
            Image.fromarray(img).save(path, "JPEG", quality=90)
        return os.path.getsize(path)

    for split in ("train", "val"):
        for c in range(REAL_CLASSES):
            os.makedirs(os.path.join(root, split, f"n{c:08d}"))
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        sizes = list(pool.map(write, jobs))
    return sum(sizes) / 1e6, len(sizes)


def loader_stats(log: str, label: str) -> dict:
    """The one loader line of a driver run's ``-v`` output, parsed."""
    import re
    found = re.findall(LOADER_LINE, log)
    if len(found) != 1:
        fail(f"{label}: expected one loader line, found {found}")
    decoder, batches, produce, wait, decoded, hits = found[0]
    return {"decoder": decoder, "batches": int(batches), "produce_ms": float(produce),
            "wait_ms": float(wait), "decoded": int(decoded), "hits": int(hits)}


def captured(torch, counters, fn, *args):
    """``fn(*args)`` with its output captured and the launch counters set to
    0 just before and read just after: ``(result, output, launches,
    seconds)``."""
    import contextlib
    import io
    gc.collect()
    torch.cuda.synchronize()
    reset_counts(counters.values())
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    torch.cuda.synchronize()
    return (result, out.getvalue(), {k: c.launches for k, c in counters.items()},
            time.perf_counter() - t0)


def run_logged(torch, counters, main, argv, label):
    """One driver run with its output captured and printed under ``label``;
    returns what ``main`` returns, the output, the launch counts and the
    driver's step times (ms, from its ``-p 1`` speed lines)."""
    import re
    result, log, got, wall = captured(torch, counters, main, argv)
    for line in log.splitlines():
        print(f"  [{label}] {line}")
    steps = [1e3 * float(t) for t in re.findall(r"^Epoch: \[\d+\]\[\d+/\d+\]\s+Time (\S+) ",
                                                 log, re.M)]
    print(f"{label}: wall {wall:.2f} s; launches {got}")
    return result, log, got, steps


def check_prefetch_exactness(torch, files, labels, device_name):
    """Check 1 of phase 3g: a pinned, threaded loader through
    ``device_batches`` at depth 2, with a SimCLR step (ResNet-50, b=128,
    F=10) on each batch, against a synchronous unpinned CPU loader with the
    same seed: every device batch equal bit for bit, over two shuffled
    epochs across ``reset()``."""
    from multimodal_active_ai_tpu_torch.data.loader import HostLoader
    from multimodal_active_ai_tpu_torch.data.prefetch import device_batches
    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
    from multimodal_active_ai_tpu_torch.ops import retina
    from multimodal_active_ai_tpu_torch.train import optimizers, schedule, simclr_train

    dev = torch.device("cuda")
    model = SimCLRModule(ARCH, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(3))
    model = model.to(dev).to(memory_format=torch.channels_last)
    state = simclr_train.TrainState(
        model, optimizers.get_optimizer("adam", model.parameters()),
        schedule.simclr_learning_rate(0.01, BATCH, len(files), BATCH, 10, 190))
    step = simclr_train.make_train_step(retina.RetinaConfig(canvas_size=CANVAS), FIXATIONS, 0.05)
    gen = torch.Generator(device=dev).manual_seed(4)
    kw = dict(batch_size=BATCH, canvas_size=CANVAS, shuffle=True, seed=11,
              num_threads=REAL_WORKERS)
    pinned = HostLoader(files, labels, prefetch=2, pin_memory=True, **kw)
    plain = HostLoader(files, labels, prefetch=0, pin_memory=False, **kw)
    compared, times = 0, []
    for epoch in range(2):
        ref = iter(plain)
        batches = device_batches(pinned, dev, depth=2)
        try:
            for i in range(len(pinned)):
                want_images, want_labels = (t.to(dev) for t in next(ref))
                # compared as soon as it arrives, while later copies are in flight
                images, lbl = next(batches)
                same = torch.equal(images, want_images) and torch.equal(lbl, want_labels)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses = step(state, images, gen)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                if not same:
                    fail(f"prefetched device batch {i} of epoch {epoch} differs from the "
                         "synchronous CPU loader's")
                if not bool(torch.isfinite(losses).all()):
                    fail(f"non-finite losses {losses.tolist()}")
                compared += 1
            if next(batches, None) is not None:
                fail(f"the pinned loader gave more than {len(pinned)} batches")
        finally:
            batches.close()
            ref.close()
        if pinned.stats["batches"] != len(pinned):
            fail(f"the pinned loader gave {pinned.stats['batches']} of {len(pinned)} batches")
        print(f"exactness epoch {epoch}: {pinned.stats_line()} (its consumer is the transfer "
              "thread)")
        pinned.reset()
        plain.reset()
    if compared != 2 * len(pinned):
        fail(f"compared {compared} batches, expected {2 * len(pinned)}")
    print(f"host->card exactness: {compared} pinned, prefetched (depth 2) device batches over 2 "
          f"shuffled epochs equal bit for bit to the synchronous unpinned CPU loader's, each "
          f"compared on arrival, then a SimCLR step on it (median "
          f"{sorted(times)[len(times) // 2]:.1f} ms) [{device_name}]")


def run_real_files_path(torch, counters, workdir, device_name):
    """Phase 3g: the drivers on image files (see the module docstring).
    Returns the median driver steps on files and the peak memory."""
    from multimodal_active_ai_tpu_torch import coco_captions_probe as cap_driver
    from multimodal_active_ai_tpu_torch import contrastive_learning as driver
    from multimodal_active_ai_tpu_torch import representation_evaluation as probe_driver
    from multimodal_active_ai_tpu_torch.data import native
    from multimodal_active_ai_tpu_torch.data.readers import list_image_folder
    from multimodal_active_ai_tpu_torch.train import simclr_train
    from multimodal_active_ai_tpu_torch.utils import checkpoint

    data = os.path.join(workdir, "images")
    cache = os.path.join(workdir, "canvas_cache")
    t0 = time.perf_counter()
    mb, count = write_real_folder(data)
    print(f"image folder: {count} files ({REAL_TRAIN} train, {REAL_VAL} val, {REAL_CLASSES} "
          f"classes), {mb:.1f} MB, written in {time.perf_counter() - t0:.1f} s")
    decoder = "native" if native.available() else "pil"
    print(f"host: os.cpu_count() {os.cpu_count()}, sched_getaffinity "
          f"{len(os.sched_getaffinity(0))} cores; decoder {decoder}; -j {REAL_WORKERS}")
    files, labels, _ = list_image_folder(os.path.join(data, "train"))
    check_prefetch_exactness(torch, files, labels, device_name)

    nb = math.ceil(REAL_TRAIN / BATCH)
    padded = nb * BATCH
    base = [data, "--dataset", "imagenet", "-b", str(BATCH), "--canvas-size", str(CANVAS),
            "--epochs", "1", "-t", "-v", "-p", "1", "-j", str(REAL_WORKERS)]
    zero = {"stat_sums": 0, "conv1x1_stats": 0, "hat_sample": 0}

    def expect(label, got, b1, stats, decoded, hits):
        if got != {"glimpse_sample": b1, **zero}:
            fail(f"{label}: launches {got}, expected glimpse_sample {b1}, others 0")
        if (stats["decoder"], stats["batches"], stats["decoded"], stats["hits"]) != (
                decoder, nb, decoded, hits):
            fail(f"{label}: loader {stats}, expected {nb} batches, {decoded} decoded, "
                 f"{hits} hits ({decoder})")

    # check 2: the SimCLR driver at full width, the cache cold
    ckdir = os.path.join(workdir, "simclr_files")
    argv = base + ["--arch", ARCH, "-f", str(FIXATIONS), "--checkpoint-dir", ckdir,
                   "--canvas-cache", cache]
    torch.cuda.reset_peak_memory_stats()
    state, log, got, simclr_steps = run_logged(torch, counters, driver.main, argv,
                                               "simclr files, cache cold")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    stats = loader_stats(log, "simclr files")
    expect("simclr files", got, nb * (1 + FIXATIONS) + 2, stats, padded, 0)
    ck = os.path.join(ckdir, "checkpoint.pth.tar")
    payload = checkpoint.load_checkpoint(ck, "cuda")
    if payload["step"] != nb * FIXATIONS or state.step != payload["step"] or not all(
            math.isfinite(x) for x in payload["loss_history"]):
        fail(f"simclr files: step {payload['step']}, loss history {payload['loss_history']}")

    # check 3: its resume to --epochs 2, served from the cache; the first
    # step sees every tensor of the checkpoint
    seen = {}
    make = simclr_train.make_train_step

    def spy(*args, **kwargs):
        inner = make(*args, **kwargs)

        def first(st, *rest):
            if not seen:
                seen.update(model={k: v.clone() for k, v in st.model.state_dict().items()},
                            opt={i: {k: v.clone() for k, v in o.items()} for i, o in
                                 st.optimizer.state_dict()["state"].items()}, step=st.step)
            return inner(st, *rest)
        return first

    simclr_train.make_train_step = spy
    try:
        resumed, log, got, resume_steps = run_logged(
            torch, counters, driver.main, argv + ["--epochs", "2", "--resume", ck],
            "simclr files, resume, cache warm")
    finally:
        simclr_train.make_train_step = make
    warm = loader_stats(log, "simclr files resume")
    expect("simclr files resume", got, nb * (1 + FIXATIONS) + 2, warm, 0, padded)
    sd, opt = payload["state_dict"], payload["optimizer"]["state"]
    if seen.get("step") != payload["step"] or sorted(seen["model"]) != sorted(sd) or not all(
            torch.equal(seen["model"][k], v) for k, v in sd.items()) or not all(
            torch.equal(seen["opt"][i][k], v) for i, st in opt.items()
            for k, v in st.items()):
        fail("simclr files resume: its first step did not see every checkpoint tensor")
    if resumed.step != 2 * nb * FIXATIONS:
        fail(f"simclr files resume: {resumed.step} updates, expected {2 * nb * FIXATIONS}")
    print(f"simclr files resume: the first step saw all {len(sd)} state_dict tensors and the "
          f"optimizer state of {len(opt)} parameters bit for bit (step {seen['step']})")

    # check 4: the probe from that checkpoint, without and with the cache
    probe = {}
    for label, extra, decoded, hits in (("cache off", [], padded, 0),
                                        ("cache warm", ["--canvas-cache", cache], 0, padded)):
        pdir = os.path.join(workdir, f"probe_files_{len(probe)}")
        pstate, log, got, steps = run_logged(
            torch, counters, probe_driver.main,
            [ck] + base + ["--arch", ARCH, "-f", str(PROBE_FIXATIONS), "--checkpoint-dir",
                           pdir] + extra, f"probe files, {label}")
        pstats = loader_stats(log, f"probe files {label}")
        expect(f"probe files {label}", got, nb + 1, pstats, decoded, hits)
        pck = checkpoint.load_checkpoint(os.path.join(pdir, "classifier_checkpoint.pth.tar"),
                                         "cuda")
        if pstate.step != nb or not all(bool(torch.isfinite(v).all())
                                        for v in pck["state_dict"].values()):
            fail(f"probe files {label}: {pstate.step} updates or non-finite weights")
        probe[label] = (steps, pstats)

    # check 5: the caption driver on the folder's class names
    cdir = os.path.join(workdir, "caption_files")
    (cstate, vocab), log, got, _ = run_logged(
        torch, counters, cap_driver.main,
        [ck, data, "--dataset", "imagefolder", "-a", ARCH, "-b", str(BATCH), "-f",
         str(PROBE_FIXATIONS), "--canvas-size", str(CANVAS), "-t", "--epochs", "1", "-v", "-p",
         "1", "-j", str(REAL_WORKERS), "--checkpoint-dir", cdir, "--canvas-cache", cache],
        "caption imagefolder")
    import re
    train_steps, eval_steps = cap_driver.loop_steps(True, nb)
    losses = [float(x) for x in re.findall(r"Loss (\S+) ", log)]
    top = {k: float(v) for k, v in re.findall(r"##(\S+ Top-\d) (\S+)", log)}
    if f"caption vocabulary: {vocab.size} entries" not in log:
        fail("caption imagefolder: no corpus vocabulary line")
    if got != {"glimpse_sample": train_steps + eval_steps, **zero} or cstate.step != train_steps:
        fail(f"caption imagefolder: launches {got}, {cstate.step} updates")
    if len(losses) != train_steps or not all(math.isfinite(x) for x in losses) or sorted(
            top) != ["I2T Top-1", "I2T Top-5", "T2I Top-1", "T2I Top-5"] or not all(
            0 <= v <= 1 for v in top.values()):
        fail(f"caption imagefolder: losses {losses}, retrieval {top}")
    print(f"caption imagefolder: vocabulary {vocab.size} words, losses "
          f"{[round(x, 4) for x in losses]}, retrieval {top}, glimpse_sample "
          f"{got['glimpse_sample']} launches ({train_steps} train + {eval_steps} eval steps); "
          f"{loader_stats(log, 'caption imagefolder')}")

    def med(xs):
        return sorted(xs)[len(xs) // 2]

    print(f"loader per batch (b={BATCH}, canvas {CANVAS}, -j {REAL_WORKERS}, {decoder}): "
          f"simclr cold produce {stats['produce_ms']:.1f} ms, wait {stats['wait_ms']:.1f} ms; "
          f"simclr warm produce {warm['produce_ms']:.1f} ms, wait {warm['wait_ms']:.1f} ms; "
          f"probe cold produce {probe['cache off'][1]['produce_ms']:.1f} ms, wait "
          f"{probe['cache off'][1]['wait_ms']:.1f} ms; probe warm produce "
          f"{probe['cache warm'][1]['produce_ms']:.1f} ms, wait "
          f"{probe['cache warm'][1]['wait_ms']:.1f} ms [{device_name}]")
    return {"simclr_cold": simclr_steps, "simclr_warm": resume_steps,
            "probe_cold": probe["cache off"][0], "probe_warm": probe["cache warm"][0],
            "simclr_cold_ms": med(simclr_steps), "simclr_warm_ms": med(resume_steps),
            "probe_cold_ms": med(probe["cache off"][0]),
            "probe_warm_ms": med(probe["cache warm"][0]), "peak_gib": peak_gib}


def run_stat_fusion_paths(torch, counters, driver, ckpt_mod, device_name):
    """Phase 3b: the driver with ``--stat-fusion pallas`` (3 train steps +
    validation, then a resume), and train steps of the ``bn_fused`` +
    ``pallas`` model through ``make_train_step``; each path's counters set
    to 0 just before it and read just after. Returns the launch counts and
    the median step times."""
    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
    from multimodal_active_ai_tpu_torch.ops import retina
    from multimodal_active_ai_tpu_torch.train import optimizers, schedule, simclr_train

    fused_b2, fused_b3 = resnet50_fused_shapes(BATCH)
    per_forward_b2, per_forward_b3 = sum(fused_b2.values()), sum(fused_b3.values())
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_fused_")
    try:
        argv = ["--dataset", "synthetic", "--arch", ARCH, "-b", str(BATCH),
                "-f", str(FIXATIONS), "--canvas-size", str(CANVAS),
                "--epochs", "1", "-t", "--num-examples", str(EXAMPLES),
                "--checkpoint-dir", ckdir, "-p", "1", "--stat-fusion", "pallas"]
        # eval mode runs the plain product with the running statistics: no
        # B3; the stem's norm alone is bn_act (each 3x3 conv's norm is the
        # module, the 1x1 convs' are B3's)
        want = {**dict.fromkeys(counters, 0),
                "glimpse_sample": TRAIN_STEPS * (1 + FIXATIONS) + 2 * EVAL_STEPS,
                "conv1x1_stats": TRAIN_STEPS * (1 + FIXATIONS) * per_forward_b3,
                **bn_act_launches(TRAIN_STEPS * (1 + FIXATIONS), TRAIN_STEPS * FIXATIONS, 1)}
        torch.cuda.synchronize()
        reset_counts(counters.values())
        state, payload, ck, wall = drive_and_check(
            torch, driver, ckpt_mod, argv, ckdir, "--stat-fusion pallas")
        got = {k: c.launches for k, c in counters.items()}
        print(f"--stat-fusion pallas path: launches {got} (expected {want}); wall "
              f"{wall:.2f} s incl. first-call set-up")
        if got != want:
            fail(f"--stat-fusion pallas launches {got}, expected {want}")
        pallas_launches = got["conv1x1_stats"]
        resumed = driver.main(argv + ["--resume", ck])
        sd = payload["state_dict"]
        now = resumed.model.state_dict()
        if resumed.step != payload["step"] or not all(
                torch.equal(now[k].cpu(), sd[k].cpu()) for k in sd):
            fail("--stat-fusion pallas resume did not restore the checkpoint")
        print(f"resume --stat-fusion pallas: restored step {resumed.step} and all "
              f"{len(sd)} state_dict tensors")
        pallas_ms = step_times(torch, state, "--stat-fusion pallas", device_name)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    dev = torch.device("cuda")
    model = SimCLRModule(ARCH, norm_kind="bn_fused", stat_fusion="pallas",
                         dtype=torch.bfloat16, generator=torch.Generator().manual_seed(15))
    model = model.to(dev).to(memory_format=torch.channels_last)
    fstate = simclr_train.TrainState(
        model, optimizers.get_optimizer("adam", model.parameters()),
        schedule.simclr_learning_rate(0.01, BATCH, EXAMPLES, BATCH, 10, 190))
    step = simclr_train.make_train_step(retina.RetinaConfig(canvas_size=CANVAS),
                                        FIXATIONS, 0.05)
    gen = torch.Generator(device=dev).manual_seed(2)
    images = torch.randint(0, 256, (BATCH, CANVAS, CANVAS, 3), generator=gen,
                           dtype=torch.uint8, device=dev)
    want = {**dict.fromkeys(counters, 0), "glimpse_sample": 1 + FIXATIONS,
            "stat_sums": (1 + FIXATIONS) * per_forward_b2,
            "conv1x1_stats": (1 + FIXATIONS) * per_forward_b3}
    torch.cuda.synchronize()
    reset_counts(counters.values())
    losses = step(fstate, images, gen)
    torch.cuda.synchronize()
    got = {k: c.launches for k, c in counters.items()}
    print(f"bn_fused + pallas train step: launches {got} (expected {want}); losses "
          f"{[round(x, 4) for x in losses.tolist()]}")
    if got != want:
        fail(f"bn_fused + pallas launches {got}, expected {want}")
    if not bool(torch.isfinite(losses).all()):
        fail(f"non-finite losses {losses.tolist()}")
    fused_ms = step_times(torch, fstate, "bn_fused + pallas", device_name)
    return {"conv1x1_stats": pallas_launches, "stat_sums": got["stat_sums"],
            "hat_sample": got["hat_sample"], "pallas_ms": pallas_ms, "bn_fused_ms": fused_ms}


# ---------------------------------------------------------------------------
# phase 3h: data parallelism. Jobs of several ranks started with torchrun
# (``python -m torch.distributed.run``), each rank this script in its
# ``--rank-job`` mode, which writes what it saw to ``<outdir>/rank<r>.pt``.

DIST_EXAMPLES = 2 * BATCH      # the downstream jobs: 2 train steps, 1 eval batch a rank


def torchrun(nproc: int, script: str, args: list[str], label: str,
             timeout: float = 600.0) -> str:
    """A torchrun job of ``nproc`` ranks of ``script args``; fails unless
    every rank exits 0 within ``timeout`` seconds. Kills the whole process
    group of the job on the way out. Returns the job's output."""
    import signal
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", script] + args
    p = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        out = ""
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    if p.returncode != 0:
        fail(f"{nproc}-rank job {label} exited {p.returncode}:\n{out[-6000:]}")
    return out


def run_ranks(torch, nproc: int, kind: str, outdir: str, argv: list[str],
              timeout: float = 600.0):
    """A torchrun job of ``nproc`` ranks of ``--rank-job kind outdir argv``
    (:func:`torchrun`). Returns the job's output and each rank's record."""
    os.makedirs(outdir, exist_ok=True)
    out = torchrun(nproc, os.path.abspath(__file__), ["--rank-job", kind, outdir] + argv, kind,
                   timeout)
    return out, [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
                 for r in range(nproc)]


def _dist_small_step(torch, dev):
    """The float32 ResNet10 SimCLR step of phase 3h(c) on this rank's rows
    (b=4 a rank, global 8; F=2, canvas 64; Adam), its draws the global
    batch's from one seeded generator on ``dev``: losses and weights."""
    from multimodal_active_ai_tpu_torch import parallel
    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
    from multimodal_active_ai_tpu_torch.ops import retina
    from multimodal_active_ai_tpu_torch.train import optimizers, schedule, simclr_train

    images = torch.randint(0, 256, (8, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(3))
    norm = "sync_bn" if parallel.world_size() > 1 else "bn"
    model = SimCLRModule("ResNet10", norm_kind=norm,
                         generator=torch.Generator().manual_seed(0)).to(dev)
    state = simclr_train.TrainState(model, optimizers.get_optimizer("adam", model.parameters()),
                                    schedule.simclr_learning_rate(0.01, 8, 64, 8, 0, 5))
    step = simclr_train.make_train_step(
        retina.RetinaConfig(canvas_size=64, crop_sizes=(40, 24, 10, 30)), 2, 0.05)
    losses = step(state, parallel.local_rows(images).to(dev),
                  torch.Generator(device=dev).manual_seed(5))
    return {"losses": losses.cpu(), "sd": {k: v.cpu() for k, v in model.state_dict().items()}}


def _collective_ms(torch, dev) -> dict:
    """Median host times of the collectives a SimCLR step makes, in this
    job's process group on ``dev``: the all-reduce of a ResNet-50 SimCLR
    model's gradient (one flat float32 buffer, F a step) and of one
    BatchNorm layer's largest ``(Σx, Σx², count)`` vector (2·2048 + 1
    floats; every train-mode BatchNorm forward and backward)."""
    import torch.distributed as dist
    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule

    with torch.device("meta"):
        numel = sum(p.numel() for p in SimCLRModule(ARCH).parameters())
    out = {"grad_floats": numel}
    for name, n, reps in (("grad", numel, 5), ("bn", 2 * 2048 + 1, 51)):
        x = torch.ones(n, device=dev)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_reduce(x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"{name}_ms"] = sorted(times)[reps // 2]
    return out


DOWNSTREAM = {   # driver module, config class, checkpoints rank 0 writes, B1 a rank
    "representation_evaluation": ("EvalConfig", ["classifier_checkpoint.pth.tar"], 2 + 1),
    "detr_image_classification": ("DETRConfig", ["detr_classifier_checkpoint.pth.tar"], 2 + 1),
    "detr_image_classification_rls": ("RLSConfig", ["detr_classifier_checkpoint.pth.tar",
                                                    "dqn_checkpoint.pth.tar"],
                                      2 * PROBE_FIXATIONS + 2 * PROBE_FIXATIONS),
    "coco_captions_probe": ("CaptionLMConfig", ["caption_probe_checkpoint.pth.tar"], 2 + 2),
}


def downstream_argv(name: str, simclr_ck: str) -> list[str]:
    """The phase-3c-3f flags of a downstream driver at 2 train steps a rank
    (its checkpoints in ``./<name>``, the rank's directory)."""
    net = "-a" if name == "coco_captions_probe" else (
        "--arch" if name == "representation_evaluation" else "--backbone")
    argv = [simclr_ck, "--dataset", "synthetic", net, ARCH, "-b", str(BATCH), "-f",
            str(PROBE_FIXATIONS), "--canvas-size", str(CANVAS), "--epochs", "1", "-t",
            "--num-examples", str(DIST_EXAMPLES), "--checkpoint-dir", name, "-p", "1"]
    return argv + (["--target-update-freq", "1"] if name.endswith("rls") else [])


def rank_job(kind: str, outdir: str, argv: list[str]) -> int:
    """One rank of a phase-3h job, in its own directory ``outdir/rank<r>``:

    * ``simclr``: ``contrastive_learning.main(argv)`` (the user's entry
      point, which joins and leaves the job's process group), with the
      launch counters set to 0 just before and read just after, its peak
      memory and final weights;
    * ``equal``: :func:`_dist_small_step` in the job's process group;
    * ``downstream``: the four downstream drivers' ``train`` in one process
      group, each from the checkpoint ``argv[0]`` with its counters set to
      0 just before and read just after;
    * ``nccl``: the port's collectives on the card in a job of one rank
      (NCCL): gather, sum, the differentiable gather and sum, and their
      gradients."""
    sys.path.insert(0, ROOT)
    import torch
    from multimodal_active_ai_tpu_torch import config, parallel
    from multimodal_active_ai_tpu_torch.ops import conv1x1_stats as cs
    from multimodal_active_ai_tpu_torch.ops import glimpse_sample as gs
    from multimodal_active_ai_tpu_torch.ops import stat_sums as ss

    counters = {"glimpse_sample": gs.glimpse_sample, "stat_sums": ss.stat_sums,
                "conv1x1_stats": cs.conv1x1_stats, "hat_sample": gs.hat_sample}
    rank = int(os.environ["RANK"])
    rdir = os.path.join(outdir, f"rank{rank}")
    os.makedirs(rdir, exist_ok=True)
    os.chdir(rdir)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = {}
    if kind == "simclr":
        from multimodal_active_ai_tpu_torch import contrastive_learning as driver
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters.values())
        state = driver.main(argv)
        torch.cuda.synchronize()
        record = {"launches": {k: c.launches for k, c in counters.items()},
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                  "sd": {k: v.cpu() for k, v in state.model.state_dict().items()}}
    else:
        dev = parallel.initialize_distributed("cuda")
        import torch.distributed as dist
        record["backend"] = dist.get_backend()
        try:
            if kind == "equal":
                record.update(_dist_small_step(torch, dev))
                record["collectives"] = _collective_ms(torch, dev)
            elif kind == "downstream":
                import importlib
                for name, (cls, _, _) in DOWNSTREAM.items():
                    module = importlib.import_module(f"{PACKAGE}.{name}")
                    cfg = config.parse_into(getattr(config, cls), downstream_argv(name, argv[0]))
                    reset_counts(counters.values())
                    t0 = time.perf_counter()
                    out = module.train(cfg, dev)
                    torch.cuda.synchronize()
                    state = out[0] if isinstance(out, tuple) else out
                    record[name] = {"launches": {k: c.launches for k, c in counters.items()},
                                    "steps": state.step, "wall_s": time.perf_counter() - t0}
            elif kind == "nccl":
                x = torch.randn(8, 16, device=dev, requires_grad=True)
                gathered = parallel.cross_replica_concat(x)
                summed = parallel.all_reduce_sum_with_grad(x * 2)
                full = parallel.all_gather_with_grad(x * 3)
                (gathered.sum() + summed.sum() + full.sum()).backward()
                record.update({"gather": bool(torch.equal(gathered, x)),
                               "sum": bool(torch.equal(summed, x * 2)),
                               "full": bool(torch.equal(full, x * 3)),
                               "grad": bool(torch.equal(x.grad, torch.full_like(x, 6.0))),
                               "mean": bool(torch.equal(parallel.all_reduce_mean(x), x))})
                torch.cuda.synchronize()
        finally:
            parallel.shutdown()
    torch.save(record, os.path.join(outdir, f"rank{rank}.pt"))
    return 0


def _step_times(log: str) -> list[float]:
    """The driver's per-step host times (``-p 1`` lines of rank 0), in ms."""
    import re
    return [float(t) * 1e3 for t in re.findall(r"^Epoch: \[\d+\]\[\d+/\d+\]\tTime ([\d.]+)",
                                               log, re.M)]


def run_multi_rank_path(torch, simclr_ck: str, workdir: str, device_name: str) -> dict:
    """Phase 3h: the port as jobs of 2 ranks, one process each.

    (a) The SimCLR driver at the main path's width (ResNet-50, ``-b 128`` a
    rank, F=10, canvas 640, bf16, 3 train steps and validation), through
    torchrun and ``contrastive_learning.main``: NCCL where the machine has 2
    cards, else 2 ranks sharing the one card over gloo (printed). Then a
    1-rank NCCL job runs the port's collectives on the card, so that NCCL's
    init, all-reduce and all-gather launch there either way.
    (b) Both ranks end with bit-identical weights, equal to rank 0's
    checkpoint, which rank 0 alone writes; B1 launched ``steps·(1+F) +
    2·eval_steps`` times on each rank, B2-B4 never; the losses finite.
    (c) The float32 ResNet10 step at 2 ranks × 4 rows equals the 1-rank
    step of the 8 rows on the card: losses to 1e-3 relative, weights in the
    structure of the CPU tests' Adam tolerances.
    (d) The four downstream drivers at 2 ranks, 2 train steps each, from
    the phase-3 checkpoint: B1 per rank as each path launches it, B2-B4
    never, rank 0 alone writing.
    (e) Step time per rank, the global img/s and the peak memory, beside
    the card's name and power limit; labelled when the ranks share a card
    (no scaling figure). (f) ``tools/torch_multiprocess_check.py`` as a
    2-rank job: both ranks print OK on the backend of (a)."""
    cards = torch.cuda.device_count()
    nproc = 2
    shared = cards < nproc
    how = ("2 ranks share the one card over gloo" if shared else "2 cards, NCCL")
    torch.cuda.empty_cache()

    # (a), (b): the SimCLR driver
    outdir = os.path.join(workdir, "dist_simclr")
    argv = ["--dataset", "synthetic", "--arch", ARCH, "-b", str(BATCH), "-f", str(FIXATIONS),
            "--canvas-size", str(CANVAS), "--epochs", "1", "-t", "--num-examples",
            str(EXAMPLES), "--checkpoint-dir", ".", "-p", "1", "--multislice"]
    t0 = time.perf_counter()
    log, ranks = run_ranks(torch, nproc, "simclr", outdir, argv)
    wall = time.perf_counter() - t0
    backend = "gloo" if shared else "nccl"
    if f"backend {backend}" not in log:
        fail(f"the 2-rank job did not report backend {backend}:\n{log[-3000:]}")
    expected = TRAIN_STEPS * (1 + FIXATIONS) + 2 * EVAL_STEPS
    want = {"glimpse_sample": expected, "stat_sums": 0, "conv1x1_stats": 0, "hat_sample": 0}
    for r, rec in enumerate(ranks):
        if rec["launches"] != want:
            fail(f"rank {r} launches {rec['launches']}, expected {want}")
    ck = os.path.join(outdir, "rank0", "checkpoint.pth.tar")
    if not os.path.isfile(ck) or os.path.exists(os.path.join(outdir, "rank1",
                                                             "checkpoint.pth.tar")):
        fail("rank 0 alone must write the checkpoint")
    payload = torch.load(ck, map_location="cpu", weights_only=False)
    sd0, sd1 = ranks[0]["sd"], ranks[1]["sd"]
    same = all(torch.equal(sd0[k], sd1[k]) and torch.equal(sd0[k], payload["state_dict"][k].cpu())
               for k in sd0)
    hist = payload["loss_history"]
    if not same:
        fail("the two ranks' weights differ, or differ from rank 0's checkpoint")
    if not hist or not all(math.isfinite(x) for x in hist):
        fail(f"non-finite loss history {hist}")
    times = _step_times(log)
    step_ms = sorted(times[1:])[len(times[1:]) // 2] if len(times) > 1 else float("nan")
    peak = max(rec["peak_gib"] for rec in ranks)
    print(f"2-rank SimCLR job ({how}; {ARCH}, b={BATCH} a rank, global {nproc * BATCH}, "
          f"F={FIXATIONS}, canvas {CANVAS}, bf16, --multislice): glimpse_sample launches "
          f"{[rec['launches']['glimpse_sample'] for rec in ranks]} a rank (expected {expected}),"
          f" B2-B4 0; weights bit-identical on both ranks and in rank 0's checkpoint "
          f"({len(sd0)} tensors), rank 1 wrote nothing; loss_history {hist}; wall {wall:.1f} s")
    label = " (2 ranks on one card: not a scaling figure)" if shared else ""
    print(f"2-rank SimCLR step{label}: {step_ms:.1f} ms a step a rank (median of steps 2-"
          f"{len(times)}, {[round(t) for t in times]}), {nproc * BATCH / step_ms * 1e3:.1f} img/s "
          f"global, peak memory {peak:.2f} GiB a rank [{device_name}]")

    _, (nccl,) = run_ranks(torch, 1, "nccl", os.path.join(workdir, "dist_nccl"), [])
    checks = {k: nccl[k] for k in ("gather", "sum", "full", "grad", "mean")}
    print(f"1-rank job: backend {nccl['backend']}; collectives on the card {checks}")
    if nccl["backend"] != "nccl" or not all(checks.values()):
        fail(f"the 1-rank NCCL job: backend {nccl['backend']}, checks {checks}")

    # (c): 2 ranks against 1 on the card
    _, (e0, e1) = run_ranks(torch, nproc, "equal", os.path.join(workdir, "dist_equal"), [])
    one = _dist_small_step(torch, torch.device("cuda"))
    lr = 0.01 * 8 / 256
    diffs = torch.cat([(e0["sd"][k] - v).abs().flatten() for k, v in one["sd"].items()
                       if v.is_floating_point() and not k.endswith(("running_mean",
                                                                    "running_var"))])
    running = max(float((e0["sd"][k] - v).abs().max() / v.abs().max())
                  for k, v in one["sd"].items() if k.endswith(("running_mean", "running_var")))
    ranks_same = all(torch.equal(e0["sd"][k], e1["sd"][k]) for k in e0["sd"])
    ok = (ranks_same and bool(torch.allclose(e0["losses"], one["losses"], rtol=1e-3, atol=0))
          and float(diffs.max()) <= 4 * lr * 1.001 and float(diffs.median()) <= 1e-2 * lr
          and float((diffs > lr / 10).float().mean()) <= 0.05 and running <= 5e-3)
    print(f"small f32 ResNet10 step on the card, 2 ranks x 4 rows ({e0['backend']}) vs 1 rank x "
          f"8 rows: losses {e0['losses'].tolist()} vs {one['losses'].tolist()} (rtol 1e-3); "
          f"weights max {float(diffs.max()) / lr:.3g} lr, median {float(diffs.median()) / lr:.3g}"
          f" lr, {float((diffs > lr / 10).float().mean()):.3%} above lr/10; running statistics "
          f"{running:.3g} of their largest value; ranks bit-identical {ranks_same} "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("the 2-rank step on the card disagrees with the 1-rank step")
    c = e0["collectives"]
    n_bn = 53                                  # ResNet-50's BatchNorm layers
    n_small = n_bn * (1 + FIXATIONS) + n_bn * FIXATIONS
    modelled = FIXATIONS * c["grad_ms"] + n_small * c["bn_ms"]
    print(f"{e0['backend']} all-reduce ({how}): "
          f"the SimCLR gradient ({c['grad_floats']:,} floats, {4 * c['grad_floats'] / 1e6:.0f} "
          f"MB) {c['grad_ms']:.1f} ms, a BatchNorm sum (4,097 floats) {c['bn_ms']:.3f} ms; a "
          f"step makes {FIXATIONS} and {n_small}: {modelled:.0f} ms of collectives in the "
          f"{step_ms:.0f} ms step [{device_name}]")

    # (d): the downstream drivers
    outdir = os.path.join(workdir, "dist_downstream")
    t0 = time.perf_counter()
    _, ranks = run_ranks(torch, nproc, "downstream", outdir, [simclr_ck])
    for name, (_, files, b1) in DOWNSTREAM.items():
        want = {"glimpse_sample": b1, "stat_sums": 0, "conv1x1_stats": 0, "hat_sample": 0}
        got = [rec[name]["launches"] for rec in ranks]
        written = [os.path.isfile(os.path.join(outdir, f"rank{r}", name, f))
                   for r in range(nproc) for f in files]
        print(f"2-rank {name}: launches {got[0]} a rank (expected {want}), updates "
              f"{[rec[name]['steps'] for rec in ranks]}, {files} by rank 0 alone "
              f"{written == [True] * len(files) + [False] * len(files)}, "
              f"{ranks[0][name]['wall_s']:.1f} s")
        if any(g != want for g in got):
            fail(f"2-rank {name} launches {got}, expected {want}")
        if written != [True] * len(files) + [False] * len(files):
            fail(f"2-rank {name}: rank 0 alone must write {files}")
    print(f"phase 3h(d) (four drivers at 2 ranks): {time.perf_counter() - t0:.1f} s")

    # (f): tools/torch_multiprocess_check.py, the port of the JAX package's
    # multi-process check, as a 2-rank job
    out = torchrun(nproc, os.path.join(ROOT, "tools", "torch_multiprocess_check.py"), [],
                   "torch_multiprocess_check", timeout=300)
    oks = sorted(line for line in out.splitlines() if line.startswith("MULTIPROCESS OK"))
    for line in oks:
        print(f"2-rank torch_multiprocess_check ({how}): {line}")
    if len(oks) != nproc or not all(f"backend {backend}" in line for line in oks):
        fail(f"torch_multiprocess_check: expected {nproc} OK lines on backend {backend}:\n"
             f"{out[-3000:]}")
    return {"step_ms": step_ms, "peak_gib": peak, "how": how}


# ---------------------------------------------------------------------------
# phase 3i: a JAX-layout SimCLR checkpoint, written here (the card's machine
# has no JAX) from the phase-3 checkpoint: the JAX package's flax msgpack of
# its driver's payload, the inverse of the port's ``from_jax_variables`` for
# the weights and Adam's moments, optax's ``adam`` chain state
# ``{'0': {count, mu, nu}, '1': {count}}``.


def _msgpack(obj, out: list) -> None:
    """Append ``obj`` encoded as ``flax.serialization.msgpack_serialize``
    does (msgpack with ``use_bin_type``, the smallest encodings; maps in
    sorted key order, as ``jax.tree_util`` rebuilds them; numpy arrays as
    flax's ext 1, numpy scalars as ext 3)."""
    import struct

    import numpy as np

    def head(n, fix, fix_max, codes):
        if n <= fix_max:
            out.append(bytes([fix | n]))
            return
        for code, fmt, top in codes:
            if n <= top:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack length {n} too large")

    if isinstance(obj, dict):
        head(len(obj), 0x80, 15, ((0xde, ">H", 0xffff), (0xdf, ">I", 0xffffffff)))
        for k in sorted(obj):
            _msgpack(k, out)
            _msgpack(obj[k], out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        inner: list = []
        _msgpack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], inner)
        payload = b"".join(inner)
        code = 1 if isinstance(obj, np.ndarray) else 3
        fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}.get(len(payload))
        if fixext:
            out.append(bytes([fixext, code]))
        else:
            for lead, fmt, top in ((0xc7, ">B", 0xff), (0xc8, ">H", 0xffff),
                                   (0xc9, ">I", 0xffffffff)):
                if len(payload) <= top:
                    out.append(bytes([lead]) + struct.pack(fmt, len(payload)) + bytes([code]))
                    break
        out.append(payload)
    elif obj is None or isinstance(obj, bool):
        out.append({None: b"\xc0", False: b"\xc2", True: b"\xc3"}[obj])
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7f or -32 <= obj < 0:
            out.append(struct.pack(">b" if obj < 0 else ">B", obj))
        elif obj > 0:
            for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                                   (0xce, ">I", 0xffffffff), (0xcf, ">Q", 2**64 - 1)):
                if obj <= top:
                    out.append(bytes([code]) + struct.pack(fmt, obj))
                    break
        else:
            for code, fmt, low in ((0xd0, ">b", -2**7), (0xd1, ">h", -2**15),
                                   (0xd2, ">i", -2**31), (0xd3, ">q", -2**63)):
                if obj >= low:
                    out.append(bytes([code]) + struct.pack(fmt, obj))
                    break
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        head(len(data), 0xa0, 31, ((0xd9, ">B", 0xff), (0xda, ">H", 0xffff),
                                   (0xdb, ">I", 0xffffffff)))
        out.append(data)
    elif isinstance(obj, bytes):
        head(len(obj), 0, -1, ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff),
                               (0xc6, ">I", 0xffffffff)))
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        head(len(obj), 0x90, 15, ((0xdc, ">H", 0xffff), (0xdd, ">I", 0xffffffff)))
        for v in obj:
            _msgpack(v, out)
    else:
        raise TypeError(f"cannot encode {type(obj).__name__}")


def flax_msgpack_bytes(tree) -> bytes:
    """``tree`` (dicts with str keys; numpy arrays and scalars, Python
    numbers, str, bytes, lists) as the bytes of the JAX package's
    checkpoint files. No array here reaches flax's 1 GiB chunk size."""
    out: list = []
    _msgpack(tree, out)
    return b"".join(out)


def _jax_slots(n_main: int, part: str) -> str:
    """The flax slot of a port block part (``conv2`` → ``Conv_1``, ``bn2``
    → ``BatchNorm_1``, ``downsample.0``/``.1`` → the slot after the main
    convs)."""
    if part.startswith("downsample."):
        kind = "Conv" if part.endswith("0") else "BatchNorm"
        return f"{kind}_{n_main}"
    kind = "Conv" if part.startswith("conv") else "BatchNorm"
    return f"{kind}_{int(part[-1]) - 1}"


def to_jax_simclr(sd: dict, with_stats: bool = True):
    """A port SimCLR ``state_dict`` (the reference torch layout) → the JAX
    ``SimCLRModule``'s ``(params, batch_stats)`` in the unfused layout: the
    inverse of ``utils/checkpoint.from_jax_variables``, a pure reordering
    (convs OIHW → HWIO, Dense kernels transposed, ``g``'s ``Dense_0`` rows
    from the C-major flatten back to NHWC). ``with_stats=False`` maps a
    tree of the parameters alone (Adam's moments) and returns no
    statistics."""
    import numpy as np

    params: dict = {}
    stats: dict = {}

    def put(tree, path, value):
        for key in path[:-1]:
            tree = tree.setdefault(key, {})
        tree[path[-1]] = np.ascontiguousarray(value, dtype=np.float32)

    n_main = {}
    for key in sd:
        if key.startswith("f.layer") and ".conv" in key:
            block = ".".join(key.split(".")[1:3])
            n_main[block] = max(n_main.get(block, 0), int(key.split(".")[3][-1]))
    for key, value in sd.items():
        v = value.detach().cpu().numpy() if hasattr(value, "detach") else np.asarray(value)
        parts = key.split(".")
        if parts[-1] == "num_batches_tracked":
            continue
        if parts[0] == "g":
            dense = f"Dense_{int(parts[2]) // 2}"
            if parts[-1] == "bias":
                put(params, ("g", dense, "bias"), v)
            elif dense == "Dense_0":
                out_dim, cin = v.shape
                c = cin // 16
                put(params, ("g", dense, "kernel"), np.transpose(
                    v.reshape(out_dim, c, 4, 4), (2, 3, 1, 0)).reshape(16 * c, out_dim))
            else:
                put(params, ("g", dense, "kernel"), v.T)
            continue
        if parts[1] in ("conv1", "bn1"):
            mod, leaf = ("f", parts[1]), parts[2]
        else:
            block = f"layer{parts[1][5:]}_{parts[2]}"
            part = ".".join(parts[3:-1])
            mod = ("f", block, _jax_slots(n_main[parts[1] + "." + parts[2]], part))
            leaf = parts[-1]
        if leaf == "weight" and v.ndim == 4:
            put(params, mod + ("kernel",), np.transpose(v, (2, 3, 1, 0)))
        elif leaf in ("weight", "bias"):
            put(params, mod + ({"weight": "scale", "bias": "bias"}[leaf],), v)
        elif with_stats:
            put(stats, mod + ({"running_mean": "mean", "running_var": "var"}[leaf],), v)
    return (params, stats) if with_stats else params


def jax_simclr_payload(torch, payload: dict, model) -> dict:
    """The JAX SimCLR driver's checkpoint of the state a port ``payload``
    holds (``model`` names the optimizer's parameter indices): weights and
    statistics, optax ``adam``'s moments and counts, step, epoch, best
    top-1, histories and time."""
    import numpy as np

    names = [n for n, _ in model.named_parameters()]
    opt = payload["optimizer"]
    order = opt["param_groups"][0]["params"]
    moments = {k: to_jax_simclr({names[i]: opt["state"][i][k] for i in order}, False)
               for k in ("exp_avg", "exp_avg_sq")}
    counts = {int(opt["state"][i]["step"]) for i in order}
    if len(counts) != 1:
        fail(f"Adam counts differ across parameters: {sorted(counts)}")
    params, stats = to_jax_simclr(payload["state_dict"])
    i32 = lambda n: np.asarray(n, np.int32)   # noqa: E731  (optax's int32 counts)
    return {"epoch": int(payload["epoch"]), "step": int(payload["step"]),
            "state_dict": {"params": params, "batch_stats": stats},
            "best_prec1": float(payload["best_prec1"]),
            "optimizer": {"0": {"count": i32(counts.pop()), "mu": moments["exp_avg"],
                                "nu": moments["exp_avg_sq"]},
                          "1": {"count": i32(payload.get("count", payload["step"]))}},
            **{k: np.asarray(payload[k], np.float64)
               for k in ("loss_history", "top1_acc_history", "top5_acc_history")},
            "total_time": {k: float(v) for k, v in payload["total_time"].items()}}


def run_jax_resume_path(torch, counters, driver, ckpt_mod, simclr_ck, workdir, device_name):
    """Phase 3i: the SimCLR driver resumed on the card from a JAX-layout
    msgpack of the phase-3 state and from the port's own ``.pth.tar`` of
    it (epoch 1 of 2: 3 train steps and validation, cuDNN deterministic):
    the first resumed step's losses and the weights after it bit-identical,
    B1 launched as the path launches it, B2-B4 never."""
    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
    from multimodal_active_ai_tpu_torch.train import simclr_train

    payload = ckpt_mod.load_checkpoint(simclr_ck)
    with torch.device("meta"):
        model = SimCLRModule(arch=ARCH)
    t0 = time.perf_counter()
    jax_file = os.path.join(workdir, "jax_checkpoint.msgpack")
    data = flax_msgpack_bytes(jax_simclr_payload(torch, payload, model))
    with open(jax_file, "wb") as f:
        f.write(data)
    back = ckpt_mod.load_checkpoint(jax_file)
    if ckpt_mod.is_torch_file(jax_file) or back["step"] != payload["step"]:
        fail("the JAX-layout checkpoint does not read back")
    print(f"JAX-layout checkpoint: {len(data) / 2**20:.1f} MiB written and read back in "
          f"{time.perf_counter() - t0:.1f} s (step {back['step']}, Adam count "
          f"{int(back['optimizer']['0']['count'])})")

    make = simclr_train.make_train_step
    expected = {"glimpse_sample": TRAIN_STEPS * (1 + FIXATIONS) + 2 * EVAL_STEPS,
                "stat_sums": 0, "conv1x1_stats": 0, "hat_sample": 0}
    firsts = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for label, resume in (("JAX msgpack", jax_file), ("port .pth.tar", simclr_ck)):
            seen: dict = {}

            def spy(*a, **k):
                step = make(*a, **k)

                def first(state, images, gen=None, **kw):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    losses = step(state, images, gen, **kw)
                    if not seen:
                        torch.cuda.synchronize()
                        seen["ms"] = (time.perf_counter() - t0) * 1e3
                        seen["losses"] = losses.clone()
                        seen["sd"] = {n: t.detach().clone()
                                      for n, t in state.model.state_dict().items()}
                    return losses
                return first

            ckdir = os.path.join(workdir, f"resume_{len(firsts)}")
            argv = ["--dataset", "synthetic", "--arch", ARCH, "-b", str(BATCH), "-f",
                    str(FIXATIONS), "--canvas-size", str(CANVAS), "--epochs", "2", "-t",
                    "--num-examples", str(EXAMPLES), "--checkpoint-dir", ckdir, "-p", "1",
                    "--resume", resume]
            simclr_train.make_train_step = spy
            reset_counts(counters.values())
            try:
                t0 = time.perf_counter()
                state = driver.main(argv)
                torch.cuda.synchronize()
            finally:
                simclr_train.make_train_step = make
            got = {k: c.launches for k, c in counters.items()}
            print(f"resume from the {label}: step {state.step} (count {state.count}), first "
                  f"step {seen['ms']:.1f} ms, its losses "
                  f"{[round(x, 4) for x in seen['losses'].tolist()]}, launches {got}, driver "
                  f"run {time.perf_counter() - t0:.1f} s [{device_name}]")
            if got != expected:
                fail(f"resume from the {label}: launches {got}, expected {expected}")
            if state.step != payload["step"] + TRAIN_STEPS * FIXATIONS:
                fail(f"resume from the {label}: step {state.step}")
            firsts[label] = seen
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b = firsts.values()
    same_losses = torch.equal(a["losses"], b["losses"])
    # BatchNorm's num_batches_tracked counts forwards since the weights were
    # loaded: the JAX layout has no such counter (a JAX file starts it at
    # 0), and the port's BatchNorm never reads it
    weights = [n for n in a["sd"] if not n.endswith("num_batches_tracked")]
    differ = [n for n in weights if not torch.equal(a["sd"][n], b["sd"][n])]
    print(f"first resumed step, JAX msgpack vs port .pth.tar: losses bit-identical "
          f"{same_losses}; {len(weights) - len(differ)} of {len(weights)} weights and "
          f"statistics bit-identical after it ({len(a['sd']) - len(weights)} "
          f"num_batches_tracked counters apart) [{device_name}]")
    if not same_losses or differ:
        fail(f"the two resumes' first steps differ: {differ[:5]}")


# ---------------------------------------------------------------------------
# phase 3j: the retina's fused and canvas modes on the card


def run_retina_modes_path(torch, counters, device_name) -> dict:
    """Phase 3j: the ``canvas`` mode on the card against
    ``tests/data/dali_golden.npz`` (``tests/test_dali_golden.py``'s bounds)
    and against the CPU; the ``fused`` mode against the CPU at the main
    path's width; then 3 SimCLR train steps with each mode at the main
    path's width (ResNet-50, b=128, F=10, canvas 640, bf16): the median
    step, the peak memory, B1 never launched. Returns the times."""
    import numpy as np

    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
    from multimodal_active_ai_tpu_torch.ops import retina
    from multimodal_active_ai_tpu_torch.train import optimizers, schedule, simclr_train

    dev = torch.device("cuda")
    data = np.load(os.path.join(ROOT, "tests", "data", "dali_golden.npz"))
    cases = {"labeled": dict(fix_yx=(0.3, 0.7), angle=13.5),
             "unlabeled_geo": dict(fix_yx=(0.6, 0.2), angle=-20.0, rrc_origin_yx=(50, 80),
                                   rrc_size_hw=(500, 430), flip=True)}
    canvas_cfg = retina.RetinaConfig(canvas_size=CANVAS, mode="canvas")
    src = torch.from_numpy(data["source"][None])
    for name, kw in cases.items():
        p = retina.neutral_params(1, CANVAS)._replace(
            fix_yx=torch.tensor([kw["fix_yx"]]), angle=torch.tensor([kw["angle"]]))
        if "flip" in kw:
            f32 = torch.float32
            p = p._replace(rrc_origin_yx=torch.tensor([kw["rrc_origin_yx"]], dtype=f32),
                           rrc_size_hw=torch.tensor([kw["rrc_size_hw"]], dtype=f32),
                           flip=torch.tensor([kw["flip"]]))
        cpu = retina.apply_retina(src, p, canvas_cfg, False)[0]
        card = retina.apply_retina(src.to(dev), retina.AugParams(*(t.to(dev) for t in p)),
                                   canvas_cfg, False)[0].cpu()
        d = (card - torch.from_numpy(data[f"expected_{name}"])).abs().numpy()
        vs_cpu = float((card - cpu).abs().max())
        print(f"canvas mode on the card, golden '{name}': mean |d| {d.mean():.3f} (bound 1.5), "
              f"p99 {np.percentile(d, 99):.2f} (bound 7); max |card - cpu| {vs_cpu:.2e} "
              f"(bound 1e-3)")
        if d.mean() >= 1.5 or np.percentile(d, 99) >= 7.0 or vs_cpu > 1e-3:
            fail(f"canvas mode on the card misses the golden '{name}' or the CPU")

    gen = torch.Generator().manual_seed(21)
    images = torch.randint(0, 256, (BATCH, CANVAS, CANVAS, 3), generator=gen, dtype=torch.uint8)
    fused_cfg = retina.RetinaConfig(canvas_size=CANVAS, mode="fused", grid_mask_prob=1.0,
                                    gaussian_noise_prob=1.0, color_aug_prob=1.0)
    p = retina.sample_unlabeled_params(gen, BATCH, CANVAS, fused_cfg)
    noise = torch.randn(retina.noise_shape(fused_cfg, BATCH), generator=gen)
    cpu = retina.apply_retina(images, p, fused_cfg, True, noise=noise)
    card = retina.apply_retina(images.to(dev), retina.AugParams(*(t.to(dev) for t in p)),
                               fused_cfg, True, noise=noise.to(dev)).cpu()
    # The view tolerance of the CPU tests, |d| <= 1e-2 + 1e-4|cpu|: f32
    # sin/cos and FMA contraction differ by ulps between the card and the
    # CPU, and noise (std up to 100) and the colour twist carry values to
    # ~850. A coordinate an ulp apart can also cross a step of the
    # sampler: JAX's edge clamp (y in [-1, 0) reads pixels 0 and 1 with
    # weight y + 1 on pixel 1), a grid-mask or canvas-edge boundary. So at
    # most 1e-4 of the elements may fall outside it.
    err = (card - cpu).abs()
    outside = int((err > 1e-2 + 1e-4 * cpu.abs()).sum())
    print(f"fused mode on the card vs the CPU (b={BATCH}, canvas {CANVAS}, photometric): "
          f"max |d| {float(err.max()):.2e} of values to {float(cpu.abs().max()):.1f}; "
          f"{outside} of {err.numel()} elements outside 1e-2 + 1e-4|cpu| (bound "
          f"{int(1e-4 * err.numel())})")
    if outside > 1e-4 * err.numel():
        fail(f"fused mode on the card differs from the CPU in {outside} elements")

    # the canvas retina alone: ms a view of b=128 at canvas 640 (photometric)
    canvas_photo = retina.RetinaConfig(canvas_size=CANVAS, mode="canvas", grid_mask_prob=1.0,
                                       gaussian_noise_prob=1.0, color_aug_prob=1.0)
    dgen = torch.Generator(device=dev).manual_seed(22)
    dimages = images.to(dev)
    view_ms = {}
    for label, cfg in (("fused", fused_cfg), ("canvas", canvas_photo)):
        def view():
            q = retina.sample_unlabeled_params(dgen, BATCH, CANVAS, cfg)
            return retina.apply_retina(dimages, q, cfg, True, generator=dgen)
        view()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            view()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        view_ms[label] = sorted(times)[2]
        print(f"{label} retina view (b={BATCH}, canvas {CANVAS}, photometric): median "
              f"{view_ms[label]:.2f} ms over 5 {[round(t, 2) for t in times]} [{device_name}]")

    out = {"view_ms": view_ms}
    for mode in ("fused", "canvas"):
        cfg = retina.RetinaConfig(canvas_size=CANVAS, mode=mode)
        model = SimCLRModule(ARCH, dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(23))
        model = model.to(dev).to(memory_format=torch.channels_last)
        state = simclr_train.TrainState(
            model, optimizers.get_optimizer("adam", model.parameters()),
            schedule.simclr_learning_rate(0.01, BATCH, EXAMPLES, BATCH, 10, 190))
        step = simclr_train.make_train_step(cfg, FIXATIONS, 0.05)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters.values())

        def checked():
            losses = step(state, dimages, dgen)
            if not bool(torch.isfinite(losses).all()):
                fail(f"{mode} step: non-finite losses {losses.tolist()}")

        ms = median_step_ms(torch, checked, f"retina {mode}", device_name, FIXATIONS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = {k: c.launches for k, c in counters.items()}
        print(f"retina {mode} SimCLR steps: peak memory {peak:.2f} GiB, launches {got}")
        if any(got.values()):
            fail(f"retina {mode} launched kernels of the matmul path: {got}")
        out[mode] = (ms, peak)
        del model, state
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3k: dropout drawn as the JAX package draws it, the async checkpointer,
# the profiling module, the legacy and 1-D ResNets, the example twins and
# --unroll-fixations, on the card


def _detr_argv(simclr_ck: str, ckdir: str, seed: int) -> list[str]:
    return [simclr_ck, "--dataset", "synthetic", "--backbone", ARCH, "-b", str(BATCH),
            "-f", str(PROBE_FIXATIONS), "--canvas-size", str(CANVAS), "--epochs", "1", "-t",
            "--num-examples", str(EXAMPLES), "--checkpoint-dir", ckdir, "-p", "1",
            "--dropout", "0.1", "--seed", str(seed)]


def _set_dropout(model, rate: float) -> None:
    """Every dropout rate of a transformer model (attention and activations)."""
    from multimodal_active_ai_tpu_torch.models import transformer
    for m in model.modules():
        if isinstance(m, transformer.MultiheadAttention):
            m.dropout = rate
        elif isinstance(m, transformer._FeedForward):
            m.rate = rate


def _draw_ms(torch, shapes, dev) -> float:
    """Device ms of one step's dropout draws alone (the keep masks of
    ``shapes``), the mean of 5 replays timed with CUDA events."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def replay():
        for shape in shapes:
            torch.rand(shape, generator=gen, device=dev).lt_(0.9)

    replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 5


def _step_and_busy(torch, step, label, device_name, steps, what=None) -> tuple[float, float]:
    """The median host ms of ``step`` (``median_step_ms``), then one traced
    step's device busy ms (``utils/profiling``), printed with its launches."""
    from multimodal_active_ai_tpu_torch.utils import profiling
    ms = median_step_ms(torch, step, label, device_name, PROBE_FIXATIONS, steps=steps, what=what)
    with profiling.trace() as prof:
        step()
        torch.cuda.synchronize()
    ops = profiling.device_leaf_ops(prof)
    busy = sum(us for _, us in ops) / 1e3
    print(f"traced step {label}: device busy {busy:.2f} ms in {len(ops)} kernels, memsets and "
          f"copies [{device_name}]")
    return ms, busy


def run_dropout_checks(torch, simclr_ck, workdir, device_name) -> dict:
    """Phase 3k(a): the DETR driver at phase 3d's width from the phase-3
    checkpoint with ``--dropout 0.1``. Its train-mode attention calls: every
    keep mask one ``(Sq, Sk)`` pattern for all 128 rows and 8 heads (seen
    where the eval-mode weight is positive), the keep rate within 4σ of 0.9.
    Two runs at ``--seed 15`` (cuDNN deterministic): the first step's loss
    bit-identical (forward only), the later steps' largest difference
    printed; ``--seed 16``: another first-step loss. Then what the draws
    cost: the elements drawn a DETR and a caption step, their device ms
    alone, and each step's median and device busy ms with dropout 0.1
    beside 0."""
    from multimodal_active_ai_tpu_torch import coco_captions_probe as cap_driver
    from multimodal_active_ai_tpu_torch import detr_image_classification as detr_driver
    from multimodal_active_ai_tpu_torch.models import transformer
    from multimodal_active_ai_tpu_torch.models.resnet import encoder_feature_dim
    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
    from multimodal_active_ai_tpu_torch.models.text import TextEncoder
    from multimodal_active_ai_tpu_torch.objectives.set_criterion import SetCriterion
    from multimodal_active_ai_tpu_torch.ops import retina
    from multimodal_active_ai_tpu_torch.representation_evaluation import load_pretrained_encoder
    from multimodal_active_ai_tpu_torch.train import caption_probe, detr_train, optimizers
    from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState

    MHA = transformer.MultiheadAttention
    weights_of, draw, make = MHA.attention_weights, transformer._draw, detr_train.make_detr_train_step
    attn = {"calls": 0, "mixed": 0, "kept": 0, "seen": 0}
    shapes: list = []

    def record_weights(self, q, k, key_padding_mask=None, attn_mask=None, generator=None):
        w = weights_of(self, q, k, key_padding_mask, attn_mask, generator)
        if self.training and self.dropout:
            self.training = False
            try:
                soft = weights_of(self, q, k, key_padding_mask, attn_mask)
            finally:
                self.training = True
            valid = soft > 0
            dropped = (w == 0) & valid
            any_drop = dropped.flatten(0, 1).any(0)
            any_keep = (valid & ~dropped).flatten(0, 1).any(0)
            attn["calls"] += 1
            attn["mixed"] += int((any_drop & any_keep).sum())
            attn["kept"] += int((any_keep & ~any_drop).sum())
            attn["seen"] += int(valid.flatten(0, 1).any(0).sum())
        return w

    def record_draw(shape, rate, generator, device):
        shapes.append(tuple(shape))
        return draw(shape, rate, generator, device)

    def run(seed: int, instrumented: bool):
        losses: list = []

        def spy(*a, **k):
            step = make(*a, **k)

            def first(*args, **kw):
                m = step(*args, **kw)
                losses.append(float(m["loss_ce"]))
                return m
            return first

        detr_train.make_detr_train_step = spy
        if instrumented:
            MHA.attention_weights, transformer._draw = record_weights, record_draw
        try:
            state = detr_driver.main(_detr_argv(simclr_ck, os.path.join(
                workdir, f"dropout_{seed}_{instrumented}"), seed))
        finally:
            detr_train.make_detr_train_step = make
            MHA.attention_weights, transformer._draw = weights_of, draw
        return state, losses

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _, first = run(15, True)
        state, again = run(15, False)
        _, other = run(16, False)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    n = attn["seen"]
    rate = attn["kept"] / max(n, 1)
    sigma = math.sqrt(0.9 * 0.1 / max(n, 1))
    print(f"dropout on the card (DETR {ARCH} backbone, 6 + 6 layers, hidden 256, FFN 2048, "
          f"b={BATCH}, F={PROBE_FIXATIONS}, --dropout 0.1): {attn['calls']} train-mode "
          f"attention calls; positions whose keep mask differs across rows or heads: "
          f"{attn['mixed']} of {n}; keep rate {rate:.4f} (0.9 ± 4σ = {4 * sigma:.4f})")
    if not attn["calls"] or attn["mixed"] or abs(rate - 0.9) > 4 * sigma:
        fail(f"attention dropout is not one (1, 1, Sq, Sk) mask at keep 0.9: {attn}")
    later = max((abs(a - b) for a, b in zip(first[1:], again[1:])), default=0.0)
    print(f"dropout is a function of --seed: first-step loss seed 15 {first[0]!r} and "
          f"{again[0]!r} (bit-identical {first[0] == again[0]}), seed 16 {other[0]!r}; later "
          f"steps' largest difference at seed 15 {later:.3e} over {len(first) - 1} steps")
    if first[0] != again[0] or other[0] == first[0] or len(first) != TRAIN_STEPS:
        fail(f"DETR first-step losses {first}, {again}, {other}")

    # what the draws cost: the DETR step's and the caption step's
    dev = torch.device("cuda")
    steps_drawn = shapes[:len(shapes) // TRAIN_STEPS]
    detr_elems = sum(math.prod(s) for s in steps_drawn)
    gen = torch.Generator(device=dev).manual_seed(30)
    drop = torch.Generator(device=dev).manual_seed(31)
    images = torch.randint(0, 256, (BATCH, CANVAS, CANVAS, 3), generator=gen,
                           dtype=torch.uint8, device=dev)
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    cfg = retina.RetinaConfig(canvas_size=CANVAS)
    step = detr_train.make_detr_train_step(SetCriterion(10, 1000), cfg, PROBE_FIXATIONS, 0.1)
    out = {"detr_draw_ms": _draw_ms(torch, steps_drawn, dev), "detr_elems": detr_elems}
    for rate in (0.1, 0.0):
        _set_dropout(state.model, rate)
        out[f"detr_{rate}"] = _step_and_busy(
            torch, lambda: step(state, images, labels, gen, dropout_generator=drop),
            f"DETR, dropout {rate}", device_name, steps=9)
    _set_dropout(state.model, 0.1)
    del state

    encoder = SimCLRModule(ARCH).to(dev).to(memory_format=torch.channels_last)
    load_pretrained_encoder(encoder, simclr_ck, dev)
    seeded = torch.Generator().manual_seed(16)
    towers = caption_probe.CaptionTowers(encoder_feature_dim(ARCH) * 16 * PROBE_FIXATIONS,
                                         TextEncoder(generator=seeded), generator=seeded).to(dev)
    cstate = TrainState(towers, optimizers.get_optimizer("adam", towers.parameters()),
                        lambda _: 1e-4)
    tokens = cap_driver.caption_tokens(labels, 32768, 32)
    cstep = caption_probe.make_caption_probe_train_step(cfg, PROBE_FIXATIONS, 0.05)
    shapes.clear()
    transformer._draw = record_draw
    try:
        cstep(cstate, encoder, images, tokens, gen, dropout_generator=drop)
    finally:
        transformer._draw = draw
    out["caption_draw_ms"] = _draw_ms(torch, list(shapes), dev)
    out["caption_elems"] = sum(math.prod(s) for s in shapes)
    for rate in (0.1, 0.0):
        _set_dropout(towers, rate)
        out[f"caption_{rate}"] = _step_and_busy(
            torch, lambda: cstep(cstate, encoder, images, tokens, gen, dropout_generator=drop),
            f"caption, text dropout {rate}", device_name, steps=9,
            what=f"{ARCH} float32 encoder, b={BATCH}, F={PROBE_FIXATIONS}, text tower defaults")
    print(f"dropout draws a train step: DETR {detr_elems:,} elements in {len(steps_drawn)} "
          f"draws, {out['detr_draw_ms']:.3f} ms for the draws replayed alone; the step "
          f"{out['detr_0.1'][0]:.1f} ms (device busy {out['detr_0.1'][1]:.2f} ms) with dropout "
          f"0.1 vs {out['detr_0.0'][0]:.1f} ms ({out['detr_0.0'][1]:.2f} ms) at 0; caption "
          f"{out['caption_elems']:,} elements, {out['caption_draw_ms']:.3f} ms alone, the step "
          f"{out['caption_0.1'][0]:.1f} ms ({out['caption_0.1'][1]:.2f} ms) vs "
          f"{out['caption_0.0'][0]:.1f} ms ({out['caption_0.0'][1]:.2f} ms) [{device_name}]")
    del encoder, towers, cstate
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_async_save_checks(torch, driver, ckpt_mod, workdir, device_name):
    """Phase 3k(b): the SimCLR driver at the phase-3 width for 2 epochs of 2
    train steps (and 1 eval step each): the caller's stall in each
    ``AsyncCheckpointer.save`` beside an inline ``save_checkpoint`` of the
    same payload; the last file equal to the returned state. Then save,
    take one more train step, ``wait()``: the file holds the weights and
    Adam moments of the save, not of the step. Returns the state."""
    from multimodal_active_ai_tpu_torch.ops import retina
    from multimodal_active_ai_tpu_torch.train import simclr_train

    ckdir = os.path.join(workdir, "async")
    argv = ["--dataset", "synthetic", "--arch", ARCH, "-b", str(BATCH), "-f", str(FIXATIONS),
            "--canvas-size", str(CANVAS), "--epochs", "2", "--num-examples", str(2 * BATCH),
            "--checkpoint-dir", ckdir, "-p", "1"]
    cls = ckpt_mod.AsyncCheckpointer
    save = cls.save
    stalls: list = []

    def timed_save(self, *a, **k):
        t0 = time.perf_counter()
        save(self, *a, **k)
        stalls.append((time.perf_counter() - t0) * 1e3)

    cls.save = timed_save
    try:
        t0 = time.perf_counter()
        state = driver.main(argv)
        wall = time.perf_counter() - t0
    finally:
        cls.save = save
    ck = os.path.join(ckdir, "checkpoint.pth.tar")
    payload = ckpt_mod.load_checkpoint(ck)
    sd = state.model.state_dict()
    if payload["epoch"] != 2 or payload["step"] != 4 * FIXATIONS or not all(
            torch.equal(v, sd[k].cpu()) for k, v in payload["state_dict"].items()):
        fail(f"the async saver's last file is not the final state (epoch {payload['epoch']})")
    inline = os.path.join(ckdir, "inline.pth.tar")
    full = {"state_dict": sd, "optimizer": state.optimizer.state_dict()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt_mod.save_checkpoint(full, False, filename=inline)
    inline_ms = (time.perf_counter() - t0) * 1e3
    size_mib = os.path.getsize(inline) / 2**20
    print(f"async checkpointer (SimCLR driver, 2 epochs x 2 steps, {wall:.1f} s): the epoch-end "
          f"stall on the training thread {[round(t, 1) for t in stalls]} ms, against "
          f"{inline_ms:.1f} ms for the same {size_mib:.1f} MiB saved inline [{device_name}]")
    if len(stalls) != 2:
        fail(f"{len(stalls)} async saves, expected 2")

    step = simclr_train.make_train_step(retina.RetinaConfig(canvas_size=CANVAS), FIXATIONS, 0.05)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(32)
    images = torch.randint(0, 256, (BATCH, CANVAS, CANVAS, 3), generator=gen,
                           dtype=torch.uint8, device=dev)
    before = {k: v.clone() for k, v in sd.items()}
    moments = {i: {k: v.clone() for k, v in st.items()}
               for i, st in state.optimizer.state_dict()["state"].items()}
    saver = cls()
    snap = os.path.join(ckdir, "snapshot.pth.tar")
    t0 = time.perf_counter()
    saver.save(full, False, filename=snap)
    stall = (time.perf_counter() - t0) * 1e3
    step(state, images, gen)
    saver.wait()
    saved = ckpt_mod.load_checkpoint(snap)
    same = all(torch.equal(saved["state_dict"][k], v.cpu()) for k, v in before.items()) and all(
        torch.equal(saved["optimizer"]["state"][i][k], v.cpu())
        for i, st in moments.items() for k, v in st.items())
    moved = sum(not torch.equal(saved["state_dict"][k], v.cpu())
                for k, v in state.model.state_dict().items())
    print(f"async snapshot: save {stall:.1f} ms on the caller's thread, then a train step, then "
          f"wait(): the file holds the saved weights and Adam moments bit for bit {same}; "
          f"{moved} tensors differ from the weights after the step [{device_name}]")
    if not same or not moved:
        fail("the async save did not keep the snapshot of the save")
    return state, images, gen


def run_profiling_checks(torch, state, images, gen, workdir, device_name) -> None:
    """Phase 3k(c): one phase-3-width SimCLR step traced by
    ``utils/profiling.trace`` (its Chrome trace written), its device busy ms
    from ``device_leaf_ops`` within 1% of the same trace's device events
    (kernels, memcpys, memsets) read back from the JSON file, a parse of
    its own; ``tools/profile_torch_step.trace`` on the next step, printed
    beside (two executions of one step differ by about 1%); then
    ``StepTimer`` over 3 steps and ``device_memory_stats``."""
    import importlib.util

    from multimodal_active_ai_tpu_torch.ops import retina
    from multimodal_active_ai_tpu_torch.train import simclr_train
    from multimodal_active_ai_tpu_torch.utils import profiling

    spec = importlib.util.spec_from_file_location(
        "profile_torch_step", os.path.join(ROOT, "tools", "profile_torch_step.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    step = simclr_train.make_train_step(retina.RetinaConfig(canvas_size=CANVAS), FIXATIONS, 0.05)

    def fn():
        return step(state, images, gen)

    fn()
    torch.cuda.synchronize()
    log_dir = os.path.join(workdir, "trace")
    with profiling.trace(log_dir) as prof:
        fn()
        torch.cuda.synchronize()
    ops = profiling.device_leaf_ops(prof)
    busy = sum(us for _, us in ops) / 1e3
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy_json = sum(float(e["dur"]) for e in events) / 1e3
    ops_tool, memory_ops, busy_tool = tool.trace(fn)[:3]
    apart = 100 * abs(busy - busy_json) / max(busy_json, 1e-9)
    print(f"profiling: utils/profiling.trace + device_leaf_ops {busy:.1f} ms device busy in "
          f"{len(ops)} kernels, memsets and copies; the same trace's JSON {busy_json:.1f} ms in "
          f"{len(events)} ({apart:.2f}% apart, bound 1%); tools/profile_torch_step.trace on the "
          f"next step {busy_tool:.1f} ms in {len(ops_tool)} ({memory_ops} memsets/copies), "
          f"{100 * (busy_tool - busy) / max(busy, 1e-9):+.2f}% [{device_name}]")
    if not ops or apart > 1.0:
        fail("device_leaf_ops disagrees with the trace it read")
    timer = profiling.StepTimer()
    for _ in range(3):
        timer.start()
        timer.stop(fn())
    mem = {d: {k: f"{v / 2**30:.2f} GiB" for k, v in s.items()}
           for d, s in profiling.device_memory_stats().items()}
    print(f"StepTimer: {timer.summary(BATCH)} (SimCLR {ARCH}, b={BATCH}, F={FIXATIONS}); "
          f"device_memory_stats {mem} [{device_name}]")
    if set(mem) != {f"cuda:{i}" for i in range(torch.cuda.device_count())}:
        fail(f"device_memory_stats {mem}")


def run_model_checks(torch, device_name) -> float:
    """Phase 3k(d): ``legacy_resnet18`` on ``(1, 20, 30, 15)`` and
    ``resnet1d_101`` on ``(1, 5008, 1)``, eval mode, on the card against the
    CPU forward of the same weights (float32, TF32 off: 1e-4 of the largest
    value); then a ``legacy_resnet50`` train step (bf16 autocast, Adam) at
    b=128 on 30x30x15 glimpses, timed. Returns its median ms."""
    import copy

    from multimodal_active_ai_tpu_torch.models.resnet1d import resnet1d_101
    from multimodal_active_ai_tpu_torch.models.resnet_legacy import (
        legacy_resnet18, legacy_resnet50)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(33)
    for label, model, shape in (
            ("legacy_resnet18", legacy_resnet18(norm_kind="bn", generator=gen), (1, 20, 30, 15)),
            ("resnet1d_101", resnet1d_101(length=5008, generator=gen), (1, 5008, 1))):
        x = torch.randn(shape, generator=gen)
        with torch.no_grad():
            cpu = model.eval()(x)
            card = copy.deepcopy(model).to(dev).eval()(x.to(dev)).cpu()
        rel = float((card - cpu).abs().max() / cpu.abs().max())
        print(f"{label} {shape} -> {tuple(card.shape)} on the card, |card - cpu| {rel:.2e} of "
              f"the largest value (bound 1e-4)")
        if card.shape != cpu.shape or not rel <= 1e-4:
            fail(f"{label} on the card differs from the CPU: {rel}")

    model = legacy_resnet50(norm_kind="bn", generator=gen).to(dev)
    model = model.to(memory_format=torch.channels_last).train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-4)
    dgen = torch.Generator(device=dev).manual_seed(34)
    x = torch.rand((BATCH, 30, 30, 15), generator=dgen, device=dev) * 255

    def train_step():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            loss = model(x).float().square().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if not math.isfinite(float(loss.detach())):
            fail("non-finite legacy ResNet-50 loss")

    train_step()
    torch.cuda.reset_peak_memory_stats()
    ms = median_step_ms(torch, train_step, "legacy_resnet50", device_name, 1, steps=9,
                        what=f"b={BATCH}, 30x30x15, bf16, Adam")
    print(f"legacy_resnet50 train step peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{device_name}]")
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return ms


def _all_finite(torch, value) -> bool:
    if isinstance(value, (list, tuple)):
        return all(_all_finite(torch, v) for v in value)
    return bool(torch.isfinite(torch.as_tensor(value).float()).all())


EXAMPLE_B1 = {"torch_contrastive_learning_demo": 5,      # 2 views + a step of 1 + F = 3
              "torch_reinforced_transformer_demo": 3,    # one a fixation of the rollout
              "torch_resnet_tests": 0, "torch_retina_visualization": 0}


def run_example_checks(torch, counters, workdir, device_name) -> dict:
    """Phase 3k(e): the four example twins on the card through their
    ``main``: B1 launched by the contrastive and captioner demos as their
    chains launch it, the other kernels never; outputs finite."""
    import importlib.util

    got = {}
    for name, want in EXAMPLE_B1.items():
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        argv = ["--device", "cuda"]
        if name == "torch_retina_visualization":
            argv += ["--out", os.path.join(workdir, "retina_pyramid.png")]
        reset_counts(counters.values())
        t0 = time.perf_counter()
        out = module.main(argv)
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        finite = all(_all_finite(torch, v) for v in out.values())
        print(f"example {name}: launches {launches} (B1 expected {want}); outputs finite "
              f"{finite}; {time.perf_counter() - t0:.1f} s [{device_name}]")
        if launches != {**{k: 0 for k in counters}, "glimpse_sample": want} or not finite:
            fail(f"example {name}: launches {launches}, finite {finite}")
        got[name] = launches["glimpse_sample"]
    return got


def run_unroll_check(torch, driver, workdir, device_name) -> None:
    """Phase 3k(f): the SimCLR driver at the phase-3 width, 2 train steps,
    with ``--unroll-fixations 5`` and with ``0`` (cuDNN deterministic): the
    same per-fixation losses bit for bit."""
    from multimodal_active_ai_tpu_torch.train import simclr_train

    make = simclr_train.make_train_step
    losses: dict = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for unroll in ("0", "5"):
            got: list = []

            def spy(*a, **k):
                step = make(*a, **k)

                def each(*args, **kw):
                    out = step(*args, **kw)
                    got.append(out.clone())
                    return out
                return each

            simclr_train.make_train_step = spy
            try:
                driver.main(["--dataset", "synthetic", "--arch", ARCH, "-b", str(BATCH), "-f",
                             str(FIXATIONS), "--canvas-size", str(CANVAS), "--epochs", "1", "-t",
                             "--num-examples", str(2 * BATCH), "-p", "1", "--checkpoint-dir",
                             os.path.join(workdir, f"unroll_{unroll}"),
                             "--unroll-fixations", unroll])
            finally:
                simclr_train.make_train_step = make
            losses[unroll] = torch.stack(got).cpu()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    same = torch.equal(losses["0"], losses["5"])
    print(f"--unroll-fixations 5 vs 0 on the card: {losses['0'].numel()} per-fixation losses "
          f"over {len(losses['0'])} steps bit-identical {same} [{device_name}]")
    if not same or len(losses["0"]) != 2:
        fail(f"--unroll-fixations changed the losses: {losses}")


# ---------------------------------------------------------------------------
# phase 3l: the convergence suite on the card (tools/torch_convergence.py)

# B1 launches each case's code implies: the matmul retina launches once a
# retina call (a SimCLR view, an F·B plan of labeled fixations, a BatchNorm
# calibration pass, one fixation of an RLS rollout)
CONVERGENCE_B1 = {
    "simclr": 60 * (1 + 1) + 2 * 4 * 2,   # 60 steps of 1 + F views; 4 evals of 2 views before, 4 after
    "probe": 30 + 3,                      # 30 train steps, 3 evals
    "detr": 1 + 40 + 3,                   # an eval before, 40 train steps, 3 evals
    "dqn": 0,                             # replayed random glimpses: no retina
    "caption": 5 + 200 + 3,               # 5 calibration passes, 200 train steps, 3 evals
    "captioner": 0,                       # random glimpse memories: no retina
    "rls": (130 + 80) * 3 + 2 * 4 * 3,    # F = 3 fixations a rollout; 4 greedy and 4 random evals
}
FUSED_STEPS = 20      # 3l(c): ResNet50 bn against bn_fused + pallas
CURVE_STEPS = 20      # 3l(d): the loss curve on the CPU and the card


def _counted(torch, counters, label, want, device_name, fn, *args, **kw):
    """``fn(*args, **kw)`` with the counters set to 0 just before and read
    just after; fatal when it ran elsewhere than on the card or launched
    other counts than ``want``. Returns its result, seconds and counts."""
    reset_counts(counters.values())
    t0 = time.perf_counter()
    r = fn(*args, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = {k: c.launches for k, c in counters.items()}
    nums = {k: round(v, 4) for k, v in r.items() if isinstance(v, float)}
    print(f"convergence {label} on the card: {nums}; launches {got} (expected {want}); "
          f"{secs:.1f} s [{device_name}]")
    if r["device"] != "cuda":
        fail(f"convergence {label} ran on {r['device']}, not on the card")
    if got != want:
        fail(f"convergence {label} launched {got}, expected {want}")
    return r, secs, got


def _held(tc, case: str, label: str, r: dict, missed: list) -> None:
    m = tc.misses(case, r)
    print(f"convergence {label}: the JAX package's thresholds "
          f"{'met' if not m else 'MISSED: ' + '; '.join(m)}")
    missed += [f"{label}: {x}" for x in m]


def _rel(torch, a, b) -> float:
    a, b = (torch.tensor(x, dtype=torch.float64) for x in (a, b))
    return float(((a - b).abs() / b.abs()).max())


def run_convergence_checks(torch, counters, device_name) -> dict:
    """Phase 3l: the port learns on the card. (a) The seven cases of
    ``tools/torch_convergence.py`` on ``cuda``, float32, TF32 off, each
    held to the JAX package's thresholds (``THRESHOLDS``); (b) each case's
    kernel launches against the count its code implies
    (:data:`CONVERGENCE_B1`; B2-B4 never). (c) Case 1 with
    ``norm_kind='bn_fused'`` (B2 in each of ResNet18's 20 BatchNorms a
    train-mode forward) to the same thresholds; then case 1's
    configuration at ResNet50 for :data:`FUSED_STEPS` steps from one init
    and one generator seed, ``bn`` against ``bn_fused`` +
    ``stat_fusion='pallas'`` (B3 in the 36 Bottleneck 1x1 convs, B2 in the
    other 17 BatchNorms: (1+F)·36 and (1+F)·17 a step): each step run by
    both models from the ``bn`` run's state, per-step losses within 1%; and
    the two trained apart, their drift printed beside it. (d) The
    loss-curve configuration of ``tools/loss_curve_parity.py`` (ResNet18,
    F=2, b=64, lr 0.8, T=0.05, seed 15's glimpse stream) from one
    torch-seeded init, on the CPU and on the card, :data:`CURVE_STEPS`
    steps: per-update losses within 1%. A miss in any of them is fatal.
    Returns the launch counts and numbers the summary prints. cuDNN runs
    its deterministic algorithms here."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN's default algorithms differ from run to run, and a case's
    # numbers with them (case 1's top-1 at seed 0: 0.898 and 0.758 in two
    # runs); deterministic ones make each case a function of its seed
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _convergence_checks(torch, counters, device_name)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _convergence_checks(torch, counters, device_name) -> dict:
    import copy

    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
    from tools import torch_convergence as tc

    none = dict.fromkeys(counters, 0)
    out: dict = {"cases": {}}
    missed: list = []
    # (a), (b)
    for name, case in tc.CASES.items():
        r, secs, got = _counted(torch, counters, name,
                                {**none, "glimpse_sample": CONVERGENCE_B1[name]}, device_name,
                                case, "cuda", 0)
        _held(tc, name, name, r, missed)
        out["cases"][name] = ({k: round(v, 4) for k, v in r.items() if isinstance(v, float)},
                              secs)
        if name == "simclr":
            out["b1"] = got["glimpse_sample"]

    # (c) the fused kernels train: B2 alone in ResNet18, to the thresholds
    r, _, _ = _counted(torch, counters, "simclr bn_fused",
                       {**none, "glimpse_sample": CONVERGENCE_B1["simclr"],
                        "stat_sums": 60 * (1 + 1) * 20}, device_name,
                       tc.simclr_case, "cuda", 0, norm_kind="bn_fused")
    _held(tc, "simclr", "simclr bn_fused", r, missed)
    out["bn_fused"] = r["final_top1"]
    # ResNet50, B2 and B3: each step from one state (held), then trained apart
    fused = dict(norm_kind="bn_fused", stat_fusion="pallas")
    b2, b3 = FUSED_STEPS * (1 + 1) * 17, FUSED_STEPS * (1 + 1) * 36
    r, _, _ = _counted(torch, counters, f"ResNet50 bn_fused + pallas from the bn run's state, "
                       f"{FUSED_STEPS} steps",
                       {**none, "glimpse_sample": 2 * FUSED_STEPS * (1 + 1), "stat_sums": b2,
                        "conv1x1_stats": b3}, device_name,
                       tc.simclr_same_state, "cuda", 0, FUSED_STEPS, "ResNet50", **fused)
    rel = _rel(torch, r["candidate"], r["reference"])
    print(f"convergence ResNet50 case 1, each step from the bn run's state: bn_fused + pallas "
          f"{[round(x, 5) for x in r['candidate']]} vs bn {[round(x, 5) for x in r['reference']]}; "
          f"largest relative difference {rel:.3e} (bound 1e-2) [{device_name}]")
    if not rel <= 1e-2:
        fail(f"ResNet50 bn_fused + pallas steps {rel:.3e} from the bn steps of the same state")
    apart = {}
    b1 = FUSED_STEPS * (1 + 1) + 2 * 4 * 2
    for label, kinds, want in (
            ("bn", {}, {**none, "glimpse_sample": b1}),
            ("bn_fused + pallas", fused,
             {**none, "glimpse_sample": b1, "stat_sums": b2, "conv1x1_stats": b3})):
        r, _, got = _counted(torch, counters, f"ResNet50 {label} trained alone, {FUSED_STEPS} "
                             f"steps", want, device_name, tc.simclr_case, "cuda", 0, FUSED_STEPS,
                             arch="ResNet50", **kinds)
        if not all(math.isfinite(x) for x in r["losses"]):
            fail(f"ResNet50 {label}: a loss is not finite")
        apart[label] = r["losses"]
    drift = _rel(torch, apart["bn_fused + pallas"], apart["bn"])
    print(f"convergence ResNet50 case 1 trained apart from one init and seed: bn_fused + pallas "
          f"{[round(x, 4) for x in apart['bn_fused + pallas']]} vs bn "
          f"{[round(x, 4) for x in apart['bn']]}; largest relative difference {drift:.3e} "
          f"(not held: float32 rounding grows through Adam; see tools/torch_fused_drift.py) "
          f"[{device_name}]")
    out.update(fused_rel=rel, fused_drift=drift, b2=got["stat_sums"], b3=got["conv1x1_stats"])

    # (d) the loss curve on the card against the CPU
    model = SimCLRModule("ResNet18", generator=torch.Generator().manual_seed(15))
    card = copy.deepcopy(model).to("cuda")
    stream = tc.view_stream(15, CURVE_STEPS, 2, 64)
    curves, secs = {}, {}
    for label, m in (("cpu", model), ("cuda", card)):
        reset_counts(counters.values())
        t0 = time.perf_counter()
        curves[label] = tc.simclr_curve(m, stream, CURVE_STEPS, 2, 64)
        secs[label] = time.perf_counter() - t0
        if {k: c.launches for k, c in counters.items()} != none:
            fail(f"the loss curve on {label} launched a kernel")
    rel_d = _rel(torch, curves["cuda"], curves["cpu"])
    print(f"convergence loss curve (ResNet18, F=2, b=64, lr 0.8, T=0.05, seed 15), "
          f"{CURVE_STEPS} steps = {len(curves['cpu'])} updates: cuda "
          f"{[round(x, 5) for x in curves['cuda'].tolist()]} vs cpu "
          f"{[round(x, 5) for x in curves['cpu'].tolist()]}; largest relative difference "
          f"{rel_d:.3e} (bound 1e-2); cpu {secs['cpu']:.1f} s, cuda {secs['cuda']:.1f} s "
          f"[{device_name}]")
    if not rel_d <= 1e-2 or not all(math.isfinite(x) for x in curves["cuda"]):
        fail(f"the loss curve on the card is {rel_d:.3e} from the CPU's")
    out.update(curve_rel=rel_d, curve_steps=CURVE_STEPS)
    if missed:
        fail("convergence thresholds missed on the card: " + "; ".join(missed))
    return out


# phase 3l(e): the fused BatchNorm in a ResNet-50 update

BN_UPDATE_BATCH = 128
BN_UPDATE_SEEDS = 8     # inits, images and retina draws
CONTROL_BITS = 3        # float8 e4m3's mantissa: the precision below bf16's 7 bits
# the bf16 update's gaps from the float32 chain's, on each seed. Over the 8
# seeds on an H100 the bf16 chain and the fused update read loss 4.4e-5 to
# 2.3e-3, gradient 1 - cos (median leaf) 0.054 to 0.087 and running
# statistics 2.2e-3 to 3.1e-3; the control loss 1.9e-3 to 2.1e-2, 1 - cos
# 0.43 to 0.51, running 1.2e-2 to 2.1e-2. The loss alone cannot tell the
# control from bf16 on every seed (PERF.md §6); the direction can.
BN_UPDATE_LIMITS = {"loss": 3e-3, "grad_dir_med": 0.2, "running": 6e-3}


def round_mantissa(torch, t, bits: int):
    """``t`` rounded to ``bits`` mantissa bits (to nearest, ties to even)
    in its own type, with float32's exponent range."""
    i = t.float().view(torch.int32)
    drop = 23 - bits
    i = (i + ((1 << (drop - 1)) - 1) + ((i >> drop) & 1)) & ~((1 << drop) - 1)
    return i.view(torch.float32).to(t.dtype)


class plain_norms:
    """Within the block, the ResNet's norms run as the module, the add and
    the ReLU one after the other, as on the CPU (``models/resnet.
    conv_norm_act`` swapped for that chain): the fused kernels off. With
    ``bits``, each of those outputs is rounded to ``bits`` mantissa bits,
    its gradient passed straight through: the lower-precision control."""

    def __init__(self, bits: int | None = None):
        self.bits = bits

    def __enter__(self):
        import torch

        from multimodal_active_ai_tpu_torch.models import resnet
        bits = self.bits

        def chain(conv, norm, x, identity=None, relu=True):
            out = norm(conv(x))
            out = out if identity is None else out + identity
            out = torch.relu(out) if relu else out
            if bits is None:
                return out
            return out + (round_mantissa(torch, out.detach(), bits) - out.detach())

        self.resnet, self.kept = resnet, resnet.conv_norm_act
        resnet.conv_norm_act = chain

    def __exit__(self, *exc):
        self.resnet.conv_norm_act = self.kept


def _bn_update(torch, model, fixations: int, fused: bool, steps: int = 1, seed: int = 0,
               bits: int | None = None):
    """``steps`` SimCLR train steps (F = ``fixations``) of ``model`` on the
    card at b=128, canvas 640, from the images and retina draws of
    ``seed``, with the fused kernels or the chain (``bits``: the control):
    the losses, each parameter's last gradient and the running
    statistics."""
    from multimodal_active_ai_tpu_torch.ops import retina
    from multimodal_active_ai_tpu_torch.train import optimizers, schedule, simclr_train

    dev = torch.device("cuda")
    b = BN_UPDATE_BATCH
    state = simclr_train.TrainState(model, optimizers.get_optimizer("adam", model.parameters()),
                                    schedule.simclr_learning_rate(0.01, b, 1 << 20, b, 0, 5))
    step = simclr_train.make_train_step(retina.RetinaConfig(canvas_size=CANVAS), fixations, 0.05)
    gen = torch.Generator(device=dev).manual_seed(21 + 2 * seed)
    images = torch.randint(0, 256, (b, CANVAS, CANVAS, 3), generator=gen, dtype=torch.uint8,
                           device=dev)
    times = []
    for _ in range(steps):
        gen.manual_seed(22 + 2 * seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if fused:
            losses = step(state, images, gen)
        else:
            with plain_norms(bits):
                losses = step(state, images, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    grads = {k: p.grad.detach().float().clone() for k, p in model.named_parameters()}
    running = {k: v.clone() for k, v in model.named_buffers() if k.endswith(("_mean", "_var"))}
    return {"losses": losses.float().cpu(), "grads": grads, "running": running, "ms": times}


def _update_gaps(torch, a: dict, b: dict) -> dict:
    """How far run ``a`` is from run ``b``: the losses' largest relative gap,
    each gradient leaf's relative gap of norm and its ``1 - cos`` (median
    and largest over the leaves, those under 1e-3 of the median leaf's norm
    left out, as the benchmark's comparison does) and the running
    statistics' largest normwise gap."""
    loss = float(((a["losses"] - b["losses"]).abs() / b["losses"].abs()).max())
    norms = {k: float(g.norm()) for k, g in b["grads"].items()}
    floor = 1e-3 * sorted(norms.values())[len(norms) // 2]
    keys = [k for k, v in norms.items() if v > floor]
    gn = torch.tensor([abs(float(a["grads"][k].norm()) - norms[k]) / norms[k] for k in keys])
    cos = torch.tensor([1 - float(torch.nn.functional.cosine_similarity(
        a["grads"][k].flatten(), b["grads"][k].flatten(), dim=0)) for k in keys])
    running = max(normwise_err(a["running"][k], v)[1] for k, v in b["running"].items())
    return {"loss": loss, "grad_norm_med": float(gn.median()), "grad_norm_max": float(gn.max()),
            "grad_dir_med": float(cos.median()), "grad_dir_max": float(cos.max()),
            "running": running}


def _bn_update_model(torch, dtype, seed: int):
    """The SimCLR ResNet-50 of ``seed`` on the card, the residual ends' γ
    0.2 (the benchmark's weights: at 1 a random bf16 ResNet-50 is
    chaotic)."""
    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
    m = SimCLRModule("ResNet50", generator=torch.Generator().manual_seed(seed), dtype=dtype)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith("bn3.weight"):
                p.fill_(0.2)
    return m.to("cuda", memory_format=torch.channels_last)


def bn_update_readings(torch, ba, device_name, seeds: int = BN_UPDATE_SEEDS) -> list:
    """For each seed, one ResNet-50 SimCLR update (b=128, F=1, canvas 640)
    from one init, images and draws, cuDNN deterministic, TF32 off: the
    float32 chain, the float32 fused kernels, the bf16 (autocast) chain,
    the bf16 fused kernels and the control (the bf16 chain with each norm's
    output rounded to float8 e4m3's 3 mantissa bits). Each seed's gaps from
    the float32 chain (:func:`_update_gaps`), its four losses and the
    launches, printed; returns them a seed."""
    import copy

    kernels = {k: getattr(ba, k) for k in BN_ACT_KERNELS}
    f32, bf = torch.float32, torch.bfloat16
    out = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for seed in range(seeds):
            runs = {}
            for dtype in (f32, bf):
                init = _bn_update_model(torch, dtype, seed)
                for fused in (False, True):
                    reset_counts(kernels.values())
                    runs[(dtype, fused)] = _bn_update(torch, copy.deepcopy(init), 1, fused,
                                                      seed=seed)
                    runs[(dtype, fused)]["launches"] = {k: f.launches for k, f in kernels.items()}
            reset_counts(kernels.values())
            runs["control"] = _bn_update(torch, init, 1, False, seed=seed, bits=CONTROL_BITS)
            runs["control"]["launches"] = {k: f.launches for k, f in kernels.items()}
            del init
            ref = runs[(f32, False)]
            names = {"float32 fused": (f32, True), "bf16 chain": (bf, False),
                     "bf16 fused": (bf, True), "control": "control"}
            reading = {"seed": seed,
                       "gaps": {n: _update_gaps(torch, runs[k], ref) for n, k in names.items()},
                       "losses": {"float32 chain": float(ref["losses"][0]),
                                  **{n: float(runs[k]["losses"][0]) for n, k in names.items()}},
                       "launches": {n: runs[k]["launches"] for n, k in names.items()}}
            print(f"ResNet50 SimCLR update seed {seed} (b={BN_UPDATE_BATCH}, F=1, canvas "
                  f"{CANVAS}): losses " + ", ".join(f"{n} {v:.7f}" for n, v in
                                                    reading["losses"].items())
                  + f" [{device_name}]")
            for n, gap in reading["gaps"].items():
                print(f"  seed {seed} {n} vs float32 chain: "
                      + ", ".join(f"{k} {v:.3e}" for k, v in gap.items()))
            out.append(reading)
            del runs, ref
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


def check_bn_act_update(torch, ba, device_name) -> dict:
    """Phase 3l(e): the fused BatchNorm kernels in ResNet-50 SimCLR updates
    on the card against the unfused chain (:func:`bn_update_readings`, eight
    seeds). float32, on every seed: the two differ in the order of float32
    sums alone, so loss 1e-4, gradient norms and ``1 - cos`` (medians over
    the leaves) 1e-3, running statistics 1e-4. bf16, the configuration's
    type: the fused pass rounds once where the chain rounds twice at each
    block's end, and each rounding pattern lands the update near or far
    from float32's by chance. So on every seed the fused update lies
    within ``BN_UPDATE_LIMITS`` of the float32 chain, and the control
    outside at least one of them; the gradients' and running statistics'
    gaps, medians over the seeds, within twice the bf16 chain's. Each fused
    update launches ``bn_act_stats`` and ``bn_act_apply`` 2 x 53 times (view
    0 and view 1) and each backward kernel 53 times; the chain and the
    control none. Then one bf16 step at F=10 (the benchmark's step): 583 and
    530 launches, and its time beside the chain's (median of 3 after
    one)."""
    import copy
    import statistics

    kernels = {k: getattr(ba, k) for k in BN_ACT_KERNELS}
    readings = bn_update_readings(torch, ba, device_name)
    want, none = bn_act_launches(2, 1, 53), dict.fromkeys(kernels, 0)
    counts_ok = all(r["launches"][n] == (want if "fused" in n else none)
                    for r in readings for n in r["launches"])
    ok32 = all(g["loss"] <= 1e-4 and g["grad_norm_med"] <= 1e-3 and g["grad_dir_med"] <= 1e-3
               and g["running"] <= 1e-4 for g in (r["gaps"]["float32 fused"] for r in readings))

    def within(gap):
        return all(gap[k] <= v for k, v in BN_UPDATE_LIMITS.items())

    fused_ok = all(within(r["gaps"]["bf16 fused"]) for r in readings)
    control_out = all(not within(r["gaps"]["control"]) for r in readings)
    med = {n: {k: statistics.median(r["gaps"][n][k] for r in readings)
               for k in readings[0]["gaps"][n] if k != "loss"}
           for n in ("bf16 chain", "bf16 fused", "control")}
    grads_ok = all(v <= 2 * med["bf16 chain"][k] for k, v in med["bf16 fused"].items())
    print(f"ResNet50 SimCLR updates over {len(readings)} seeds: float32 fused vs chain within "
          f"loss 1e-4, gradient norm and direction 1e-3 (medians), running statistics 1e-4 on "
          f"each: {ok32}; bf16 within {BN_UPDATE_LIMITS} of the float32 chain on each seed: "
          f"fused {fused_ok}, chain {all(within(r['gaps']['bf16 chain']) for r in readings)}; "
          f"the control outside on each {control_out}; medians over the seeds "
          + "; ".join(f"{n} " + ", ".join(f"{k} {v:.3e}" for k, v in m.items())
                      for n, m in med.items())
          + f": bf16 fused within twice the bf16 chain's {grads_ok}; launches a fused update "
          f"{want}, the chain and the control none: {counts_ok} [{device_name}]")

    per_step = bn_act_launches(1 + FIXATIONS, FIXATIONS, 53)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        f10 = _bn_update_model(torch, torch.bfloat16, 0)
        for m, fused, steps in ((copy.deepcopy(f10), False, 4), (f10, True, 1), (f10, True, 3)):
            reset_counts(kernels.values())
            runs.append(_bn_update(torch, m, FIXATIONS, fused, steps))
            runs[-1]["launches"] = {k: f.launches for k, f in kernels.items()}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    chain10, fused10, timed10 = runs
    steps_ok = fused10["launches"] == per_step and chain10["launches"] == none
    chain_ms = sorted(chain10["ms"][1:])[1]
    fused_ms = sorted(timed10["ms"])[1]
    print(f"bn_act launches in one SimCLR step (ResNet50, b={BN_UPDATE_BATCH}, F={FIXATIONS}, "
          f"bf16): {fused10['launches']} (expected {per_step}); step {fused_ms:.1f} ms fused, "
          f"{chain_ms:.1f} ms chain (medians of 3 after one) [{device_name}]")
    if not (ok32 and fused_ok and control_out and grads_ok and counts_ok and steps_ok):
        fail("the fused BatchNorm update disagrees with the chain or launched other counts")
    return {"launches": fused10["launches"], "readings": readings, "fused_ms": fused_ms,
            "chain_ms": chain_ms}


# phase 3m: the port's bench at bench.py's card defaults

BENCH_W, BENCH_S = 3, 10     # bench.py's windows and steps on the card
BENCH_RUNS = (   # label, knobs, the windows and steps they give
    ("simclr", {}, BENCH_W, BENCH_S),
    ("detr", {"BENCH_MODE": "detr"}, BENCH_W, BENCH_S),
    ("probe", {"BENCH_MODE": "probe"}, BENCH_W, BENCH_S),
    ("rls", {"BENCH_MODE": "rls"}, BENCH_W, BENCH_S),
    ("captions", {"BENCH_MODE": "captions"}, BENCH_W, BENCH_S),
    ("simclr mfu", {"BENCH_MFU": "1", "BENCH_STEPS": "5", "BENCH_WINDOWS": "2"}, 2, 5),
    ("simclr bn_fused + pallas", {"BENCH_NORM": "bn_fused", "BENCH_STATS": "pallas",
                                  "BENCH_STEPS": "3", "BENCH_WINDOWS": "2"}, 2, 3),
    ("simclr host", {"BENCH_INPUT": "host", "BENCH_STEPS": "5"}, 1, 5),
    # last: SimCLR steps after a torch.profiler trace in the same process
    # ran 17% slower in one pairing on an H100 (PERF.md §6)
    ("simclr trace", {"BENCH_STEPS": "2", "BENCH_WINDOWS": "2"}, 2, 2),
)


def bench_per_step(label: str) -> dict:
    """The launches of one step of a bench run: B1 once a retina call (1+F
    views a SimCLR step at F=10; one F·B plan a DETR, probe or caption
    step; one a fixation of an RLS rollout at F=4), B2 in the 17 and B3 in
    the 36 fused norms of each of the 1+F ResNet50 forwards."""
    if not label.startswith("simclr"):
        return {"glimpse_sample": 4 if label == "rls" else 1}
    fused = "pallas" in label
    return {"glimpse_sample": 1 + FIXATIONS, "stat_sums": (1 + FIXATIONS) * 17 * fused,
            "conv1x1_stats": (1 + FIXATIONS) * 36 * fused}


def run_bench_checks(torch, counters, workdir, device_name) -> dict:
    """Phase 3m: ``bench.main`` in each run of :data:`BENCH_RUNS`, with the
    counters set to 0 just before and read just after; fatal unless the
    launches are those of its steps (:func:`bench_per_step` times the
    warm-up step, the timed ones and the MFU count's), the record's own
    ``launches`` the timed steps' share, every rate finite and above 0, and
    its ``device`` the card. Returns each run's record and peak GiB."""
    import contextlib
    import io

    from multimodal_active_ai_tpu_torch import bench

    out = {}
    for label, knobs, windows, steps in BENCH_RUNS:
        knobs = dict(knobs)
        if "trace" in label:
            knobs["BENCH_TRACE"] = os.path.join(workdir, "bench_trace")
        if "host" in label:
            knobs["BENCH_CACHE"] = os.path.join(workdir, "bench_cache")
        per_step = {**dict.fromkeys(counters, 0), **bench_per_step(label)}
        timed = windows * steps
        want = {k: v * (1 + timed + ("mfu" in label)) for k, v in per_step.items()}
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(counters.values())
        err, record_line = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        # the record is echoed below behind a label: the last lines of this
        # script's output stay the kernels line and the result line
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(record_line):
            rec = bench.main(knobs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: c.launches for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        notes = [x for x in err.getvalue().splitlines() if x.startswith("#")]
        rates = [rec["value"]] + rec.get("windows_img_s_chip", []) + (
            [rec["median_img_s_chip"]] if "median_img_s_chip" in rec else [])
        print(f"bench {label} ({rec['metric']}, {rec.get('config', rec.get('norm', ''))}): best "
              f"{rec['value']} img/s/chip, median {rec.get('median_img_s_chip', '-')}, windows "
              f"{rec.get('windows_img_s_chip', '-')}; launches {got} (expected {want}; the "
              f"record's timed {rec['launches']}); peak memory {peak:.2f} GiB; {secs:.1f} s "
              f"[{device_name}]")
        print(f"bench {label} record: {record_line.getvalue().strip()}")
        for note in notes:
            print(f"bench {label}: {note}")
        if got != want:
            fail(f"bench {label} launched {got}, expected {want}")
        if rec["launches"] != {k: v * timed for k, v in per_step.items()}:
            fail(f"bench {label}: the record's launches {rec['launches']} are not its "
                 f"{timed} timed steps'")
        if not all(math.isfinite(r) and r > 0 for r in rates):
            fail(f"bench {label}: a rate is not finite and positive: {rates}")
        if rec["device"]["name"] != torch.cuda.get_device_name(0) or "power_limit" not in \
                rec["device"]:
            fail(f"bench {label} ran on {rec['device']}, not on the card")
        if "mfu" in label and not any(n.startswith("# MFU:") for n in notes):
            fail(f"bench {label}: no MFU line")
        if "trace" in label and not (
                any(n.startswith("# trace of window 1") for n in notes)
                and os.path.isfile(os.path.join(knobs["BENCH_TRACE"], "trace.json"))):
            fail(f"bench {label}: no trace line or no trace.json in {knobs['BENCH_TRACE']}")
        out[label] = (rec, peak)
    return out


# ---------------------------------------------------------------------------
# phase 3n: the JAX package's driver-level learning run on the card, cut in
# epochs (tools/torch_learning_run.py), and its last diagnostics as port
# tools (torch_cue_linear_probe, torch_rls_cue_diag, torch_bn_stat_bench)

# raised from 2/4/3/3/3 after the first card runs: the probe (10 warm-up
# epochs, so its learning rate grows through the cut) reached 16.7% in 4;
# DETR first cleared 20% in epoch 3-4, RLS in epoch 4, captions' I2T 3.1%
# in epoch 5-7; captions run the JAX command's 10
LEARNING_EPOCHS = {"part1_simclr": 3, "part1_probe": 6, "part2_detr": 6, "part2_rls": 6,
                   "part2_captions": 10}
LEARNING_BOUND = 2.0     # best top-1 (I2T and T2I for captions) >= 2x chance
CUE_CORPUS = {"classes": 4, "per_class": 120, "val_per_class": 24}   # the queue9/10 corpus
CUE_JAX = {"random val per-fix": 0.701, "random val img-mean": 0.938, "oracle val per-fix": 1.000}
CUE_BATCH, RLS_DIAG_STEPS = 48, 10
BN_BENCH_ITERS = 20


def learning_b1(driver: str, argv: list[str], n_train: int, n_val: int) -> int:
    """B1 launches a leg's code implies: once a retina call, so a SimCLR
    train step launches 1+F and an eval step 2, a probe, DETR or caption
    step 1 (the caption driver's eval reads the train images), an RLS train
    step F and an RLS eval batch 2F (the random control and the policy)."""
    from tools.torch_learning_run import flag_value

    b, f = int(flag_value(argv, "-b")), int(flag_value(argv, "-f"))
    epochs = int(flag_value(argv, "--epochs"))
    steps, evals = math.ceil(n_train / b), math.ceil(n_val / b)
    per_epoch = {"contrastive_learning": steps * (1 + f) + 2 * evals,
                 "detr_image_classification_rls": steps * f + evals * 2 * f,
                 "coco_captions_probe": 2 * steps}.get(driver, steps + evals)
    return epochs * per_epoch


def run_learning_checks(torch, counters, workdir, device_name) -> dict:
    """Phase 3n. (a) The corpus of the JAX learning run
    (``tools/make_tiny_imagefolder.py``: 10 classes x 96 + 16 at 640 px, seed
    0) and the queue9/10 wide-stripe cue corpus (4 classes x 120 + 24),
    written at once; the canvas cache under ``/dev/shm``. (b) The part-1
    and part-2 legs of ``tools/torch_learning_run.py`` through each driver's
    ``main`` at the JAX commands' widths (ResNet-50, canvas 640, b=96, F=5;
    captions b=64), cut to :data:`LEARNING_EPOCHS`, each from the SimCLR
    leg's ``model_best.pth.tar``: its per-epoch numbers printed beside the
    JAX TPU run's, its best held to :data:`LEARNING_BOUND` times chance
    (SimCLR: finite losses), its B1 launches to :func:`learning_b1`'s
    count, B2-B4 to 0. (c) ``torch_cue_linear_probe`` on the
    cue corpus (R=3, 400 probe steps, b=48): oracle val per-fix and random
    img-mean above chance + 0.15, B1 twice a batch. (d) ``torch_rls_cue_diag``'s
    from-init arm, 10 steps at b=48 on the same corpus: finite CE, B1 F = 3
    a step. (e) ``torch_bn_stat_bench``: B2 within phase 2's tolerance of its
    plain version at all eight shapes, both forms timed, B2's launches
    counted. A miss in any of them is fatal. Returns what the summary
    prints."""
    import importlib
    from concurrent.futures import ThreadPoolExecutor

    from tools import torch_bn_stat_bench as bnb
    from tools import torch_cue_linear_probe as cue
    from tools import torch_learning_run as lr
    from tools import torch_rls_cue_diag as diag

    none = dict.fromkeys(counters, 0)
    out: dict = {"legs": {}}
    c = lr.CORPUS
    data, cued = os.path.join(workdir, "tiny10"), os.path.join(workdir, "cue4")
    n_train, n_val = c["classes"] * c["per_class"], c["classes"] * c["val_per_class"]
    cue_images = CUE_CORPUS["classes"] * (CUE_CORPUS["per_class"] + CUE_CORPUS["val_per_class"])
    cache = tempfile.mkdtemp(prefix="chip_smoke_cache_", dir=lr.cache_parent(
        (n_train + n_val + cue_images) * CANVAS ** 2 * 3))
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            jobs = [pool.submit(lr.make_corpus, data, c["classes"], c["per_class"],
                                c["val_per_class"], c["size"], c["seed"]),
                    pool.submit(lr.make_corpus, cued, CUE_CORPUS["classes"],
                                CUE_CORPUS["per_class"], CUE_CORPUS["val_per_class"], CANVAS,
                                0, "wide-stripe")]
            for job in jobs:
                job.result()
        out["corpus_s"] = time.perf_counter() - t0
        print(f"learning corpus: {n_train} + {n_val} JPEGs at {c['size']} px and the "
              f"wide-stripe corpus {cue_images} JPEGs, in {out['corpus_s']:.1f} s; canvas "
              f"cache in {cache}")

        # (b) the part-1 and part-2 legs, cut in epochs
        for name, epochs in LEARNING_EPOCHS.items():
            leg = lr.LEG_BY_NAME[name]
            argv = lr.leg_argv(leg, data, workdir, cache, "cuda", epochs=epochs)
            model = lr.model_path(leg, workdir)
            if model and not os.path.isfile(model):
                fail(f"learning {name}: {leg.model_from} wrote no {model}")
            driver = importlib.import_module(f"{PACKAGE}.{leg.driver}")
            _, log, got, secs = captured(torch, counters, driver.main, argv)
            s = lr.leg_summary(leg, argv, log, secs, 0)
            want = {**none, "glimpse_sample": learning_b1(leg.driver, argv, n_train, n_val)}
            print(f"learning {name} ({epochs} of the JAX run's "
                  f"{lr.flag_value(leg.argv, '--epochs')} epochs):")
            lr.print_leg(s)
            print(f"learning {name}: launches {got} (expected {want}) [{device_name}]")
            if "problem" in s:
                fail(f"learning {name}: {s['problem']}\n{log[-3000:]}")
            if got != want:
                fail(f"learning {name} launched {got}, expected {want}")
            if leg.driver == "contrastive_learning":
                if not s["loss"] or not all(math.isfinite(x) for x in s["loss"]):
                    fail(f"learning {name}: a loss is not finite: {s['loss']}")
            else:
                short = {k: v for k, v in s["best"].items() if k != "top5"
                         and not v >= LEARNING_BOUND * s["chance"]}
                if short:
                    fail(f"learning {name}: best {short} below {LEARNING_BOUND} x chance "
                         f"{s['chance']:.2f}")
            out["legs"][name] = s

        # (c) the cue probe
        cue_args = ["none", cued, "-b", str(CUE_BATCH), "--canvas-cache", cache]
        res, log, got, secs = captured(torch, counters, cue.main, cue_args)
        batches = math.ceil(CUE_CORPUS["classes"] * CUE_CORPUS["per_class"] / CUE_BATCH) + \
            math.ceil(CUE_CORPUS["classes"] * CUE_CORPUS["val_per_class"] / CUE_BATCH)
        want = {**none, "glimpse_sample": 2 * batches}
        chance = 1 / CUE_CORPUS["classes"]
        nums = {"random val per-fix": res["random-fix"][1],
                "random val img-mean": res["random-fix"][2],
                "oracle val per-fix": res["oracle-fix"][1]}
        verdict = [x for x in log.splitlines() if x.startswith("VERDICT")]
        print(f"cue linear probe (wide-stripe, R=3, b={CUE_BATCH}): " + ", ".join(
            f"{k} {v:.3f} (JAX TPU {CUE_JAX[k]:.3f})" for k, v in nums.items())
            + f"; chance {chance:.3f}, bound {chance + cue.MARGIN:.3f}; launches {got} "
            f"(expected {want}); {secs:.1f} s [{device_name}]")
        print(f"cue linear probe: {verdict}")
        if got != want:
            fail(f"cue linear probe launched {got}, expected {want}")
        if not (nums["oracle val per-fix"] > chance + cue.MARGIN
                and nums["random val img-mean"] > chance + cue.MARGIN):
            fail(f"cue linear probe below chance + {cue.MARGIN}: {nums}")
        out["cue"] = nums

        # (d) the RLS cue diagnostic's from-init arm
        diag_args = ["none", cued, "--arm", "from-init", "--steps", str(RLS_DIAG_STEPS), "-b",
                     str(CUE_BATCH), "--canvas-cache", cache]
        res, log, got, secs = captured(torch, counters, diag.main, diag_args)
        first, last = res["from-init"]
        want = {**none, "glimpse_sample": RLS_DIAG_STEPS * 3}
        print(f"RLS cue diagnostic, from-init arm ({RLS_DIAG_STEPS} steps, b={CUE_BATCH}, F=3): "
              f"CE {first:.4f} -> {last:.4f} (ln 4 = {math.log(4):.4f}); launches {got} "
              f"(expected {want}); {secs:.1f} s [{device_name}]")
        if got != want:
            fail(f"RLS cue diagnostic launched {got}, expected {want}")
        if not (math.isfinite(first) and math.isfinite(last)):
            fail(f"RLS cue diagnostic CE not finite: {first}, {last}")
        out["diag"] = (first, last)
    finally:
        shutil.rmtree(cache, ignore_errors=True)

    # (e) the BatchNorm statistics bench
    rows, log, got, secs = captured(torch, counters, bnb.run, torch.device("cuda"),
                                     torch.bfloat16, BN_BENCH_ITERS)
    bnb.print_rows(rows, device_name)
    # per shape: B2 twice in the check, then time_ms's call, warm-up and timed run
    want = {**none, "stat_sums": len(bnb.SHAPES) * (2 + 1 + 2 * BN_BENCH_ITERS)}
    print(f"BatchNorm statistics bench: launches {got} (expected {want}); {secs:.1f} s")
    if got != want:
        fail(f"BatchNorm statistics bench launched {got}, expected {want}")
    bad = [r["shape"] for r in rows if not r["ok"]]
    if bad:
        fail(f"B2 disagrees with its plain version at {bad}")
    out["bn"] = {k: sum(r[k] for r in rows) for k in ("bn_ms", "b2_ms", "bound_ms")}
    return out


CAP_B, CAP_F, CAP_LT, CAP_VOCAB, CAP_HELD = 16, 128, 64, 20480, (0, 8)


def _rel_l2(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _balance_routers(torch, model, maps, tokens, iters: int = 400) -> None:
    """Each router's correction bias set, in layer order, by the sign rule
    run on its own scores until its loads over the batch are even (as the
    benchmark's caption cell sets its seed's bias)."""
    from multimodal_active_ai_tpu_torch.models.moe import Router
    from multimodal_active_ai_tpu_torch.reference.mla_moe import balanced_bias

    def solve(router, args):
        router.e_score_correction_bias.copy_(balanced_bias(
            torch.sigmoid(args[0].float() @ router.weight.float().T), router.top_k, iters))

    hooks = [m.register_forward_pre_hook(solve) for m in model.modules()
             if isinstance(m, Router)]
    with torch.no_grad():
        model(maps, tokens)
    for h in hooks:
        h.remove()


def _routing_flips(torch, ref, model, keys, maps, tokens, seq):
    """Per MoE layer, the share of top-k choices of the bf16 program that
    the float32 reference on the same weights does not make, and the
    logits' relative gap."""
    dev, b = maps.device, tokens.shape[0]
    with torch.no_grad():
        logits, routing = model(maps, tokens)
        chosen = [r.chosen for r in routing]
        del routing
        with torch.device(dev):
            plain = ref.GlimpseVLM({**keys, "channels": 2048})
        plain.load_state_dict(model.state_dict())
        ref.exact_products()
        mf = maps.float().reshape(CAP_F, b, *maps.shape[1:])
        flips = torch.zeros(len(chosen), device=dev)
        want = []
        for i in range(0, b, 2):
            out, rr = plain(mf[:, i:i + 2].reshape(-1, *maps.shape[1:]), tokens[i:i + 2])
            want.append(out)
            for j, (c, (_, idx, _)) in enumerate(zip(chosen, rr)):
                mine = c.view(b, seq, -1)[i:i + 2].reshape(-1, c.shape[1])
                same = (mine[:, :, None] == idx[:, None, :]).any(-1).float().mean()
                flips[j] += (1.0 - same) * 2 / b
        gap = _rel_l2(logits, torch.cat(want))
    del plain, want, mf
    gc.collect()
    torch.cuda.empty_cache()
    return [round(float(f), 4) for f in flips], gap


def run_caption_lm_path(torch, device_name) -> dict:
    """Phase 3o (see the module docstring)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from multimodal_active_ai_tpu_torch.models import moe
    from multimodal_active_ai_tpu_torch.models.glimpse_vlm import GlimpseVLM, init_weights_
    from multimodal_active_ai_tpu_torch.models.moe_lm import KIMI_VL_A3B, MoELMConfig
    from multimodal_active_ai_tpu_torch.models.simclr import SimCLRModule
    from multimodal_active_ai_tpu_torch.ops import retina
    from multimodal_active_ai_tpu_torch.reference import mla_moe as ref
    from multimodal_active_ai_tpu_torch.train import caption_lm
    from multimodal_active_ai_tpu_torch.train.eval_probe import frozen_feature_maps
    from multimodal_active_ai_tpu_torch.train.simclr_train import TrainState

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(dev).manual_seed(23)
    seq = CAP_F * 4 + CAP_LT
    print(f"caption lm: torch {torch.__version__}, torch._grouped_mm "
          f"{hasattr(torch, '_grouped_mm')}, capability {torch.cuda.get_device_capability()}")

    # (a) SDPA backends at MLA's head sizes
    q = torch.randn(CAP_B, 16, seq, 192, device=dev, dtype=bf16, generator=gen)
    k = torch.randn(CAP_B, 16, seq, 192, device=dev, dtype=bf16, generator=gen)
    v = torch.randn(CAP_B, 16, seq, 128, device=dev, dtype=bf16, generator=gen)
    taken = {}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        try:
            with sdpa_kernel([be]):
                out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)
                out.float().sum().backward()
            torch.cuda.synchronize()
            taken[be.name] = True
        except RuntimeError as e:
            taken[be.name] = str(e).splitlines()[0][:120]
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(qq, kk, vv, is_causal=True).float().sum().backward()
        torch.cuda.synchronize()
    names = sorted({e.name[:90] for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and any(f in e.name.lower() for f in ("fmha", "flash", "attention", "cudnn",
                                                          "sdpa", "attn"))})
    print(f"caption lm (a): SDPA backends at (b={CAP_B}, h=16, L={seq}, d_qk=192, d_v=128) "
          f"bf16 forward+backward: {taken}; the default runs {names} [{device_name}]")
    del q, k, v, qq, kk, vv, prof

    # (b) one MoE layer: the grouped product against the loop
    layer = moe.MoE(2048, 64, 6, 1408, 2, 2.446, range(*CAP_HELD)).to(dev)
    with torch.no_grad():
        for t in (layer.experts.gate_up_proj, layer.experts.down_proj,
                  layer.shared_experts.gate_proj.weight, layer.shared_experts.up_proj.weight,
                  layer.shared_experts.down_proj.weight):
            t.normal_(0.0, 0.02, generator=gen)
        layer.gate.weight.normal_(0.0, (3 * 2048) ** -0.5, generator=gen)
    x = torch.randn(1, CAP_B * seq, 2048, device=dev, generator=gen)
    cot = torch.randn(1, CAP_B * seq, 2048, device=dev, generator=gen)
    got, ms = {}, {}
    for grouped in (True, False):
        layer.grouped = grouped
        xg = x.clone().requires_grad_()
        for rep in range(4):
            layer.zero_grad(set_to_none=True)
            xg.grad = None
            if rep == 1:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            with torch.autocast("cuda", dtype=bf16):
                out, routing = layer(xg)
            (out.float() * cot).sum().backward()
        stop = torch.cuda.Event(enable_timing=True)
        stop.record()
        torch.cuda.synchronize()
        ms[grouped] = start.elapsed_time(stop) / 3
        got[grouped] = [out, xg.grad, layer.experts.gate_up_proj.grad,
                        layer.experts.down_proj.grad, layer.gate.weight.grad]
    gaps = [_rel_l2(a, b) for a, b in zip(got[True], got[False])]
    held_rows = int(routing.load[CAP_HELD[0]:CAP_HELD[1]].sum())
    layer.grouped = True
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with torch.autocast("cuda", dtype=bf16):
            out, routing = layer(x)
        (out.float() * cot).sum().backward()
        torch.cuda.synchronize()
    print("caption lm (b): the grouped path's product kernels: " + ", ".join(sorted(
        {e.name[:80] for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
         and any(f in e.name.lower() for f in ("gemm", "grouped", "cutlass", "nvjet", "sm90"))})))
    del prof
    print(f"caption lm (b): MoE layer, {CAP_B * seq} rows, {held_rows} routed to the 8 held "
          f"experts: grouped vs loop relative L2 (out, dx, d gate_up, d down, d router) "
          f"{[f'{g:.2e}' for g in gaps]}; forward+backward grouped {ms[True]:.2f} ms, loop "
          f"{ms[False]:.2f} ms [{device_name}]")
    if max(gaps) > 2e-2:
        fail(f"the grouped product differs from the loop over the held experts: {gaps}")
    del layer, x, cot, got, out, routing, xg
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the model at the cell's shapes; top-6 flips between bf16 and float32
    rcfg = retina.RetinaConfig(canvas_size=CANVAS)
    encoder = SimCLRModule(arch=ARCH, norm_kind="frozen", dtype=bf16,
                           generator=torch.Generator().manual_seed(5)).to(dev)
    encoder = encoder.to(memory_format=torch.channels_last).eval()
    keys = {**vars(KIMI_VL_A3B), "vocab_size": CAP_VOCAB, "held": CAP_HELD}
    with torch.device(dev):
        model = GlimpseVLM(MoELMConfig.from_dict(keys), channels=2048, dtype=bf16)
    init_weights_(model, gen)
    images = torch.randint(0, 256, (CAP_B, CANVAS, CANVAS, 3), dtype=torch.uint8, device=dev,
                           generator=gen)
    length = torch.randint(8, CAP_LT + 1, (CAP_B,), device=dev, generator=gen)
    tokens = torch.randint(1, CAP_VOCAB, (CAP_B, CAP_LT), device=dev, generator=gen)
    tokens = torch.where(torch.arange(CAP_LT, device=dev) < length[:, None], tokens, 0)
    fix = torch.rand(CAP_F * CAP_B, 2, device=dev, generator=gen)
    with torch.no_grad():
        maps = frozen_feature_maps(encoder, images, rcfg, CAP_F, fix_yx=fix)
    flips = {}
    for bias in ("zero", "balanced"):
        if bias == "balanced":
            _balance_routers(torch, model, maps, tokens)
        flips[bias], logit_gap = _routing_flips(torch, ref, model, keys, maps, tokens, seq)
        print(f"caption lm (c): top-6 choices that differ, bf16 program vs float32 reference, "
              f"router bias {bias}, per MoE layer 1-26: {flips[bias]}; logits relative L2 "
              f"{logit_gap:.3e} [{device_name}]")

    # (d) train steps
    opt = caption_lm.make_caption_lm_optimizer(model, 0.1)
    state = TrainState(model, opt, lambda _: 2e-5)
    step = caption_lm.make_caption_lm_train_step(rcfg, CAP_F, 0, 1.0, 1e-4, 1e-3)
    torch.cuda.reset_peak_memory_stats()
    moe.reset_counts()
    times, losses = [], []
    for i in range(6):
        fix = torch.rand(CAP_F * CAP_B, 2, device=dev, generator=gen)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        m = step(state, encoder, images, tokens, fix_yx=fix)
        b.record()
        losses.append(m["loss"])
        times.append((a, b))
    torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    step_ms = sorted(a.elapsed_time(b) for a, b in times[2:])
    counts = moe.counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"caption lm (d): 6 steps (b={CAP_B}, F={CAP_F}, {CAP_LT} text positions, "
          f"{CAP_B * seq} tokens), losses {[round(x, 4) for x in losses]}, MoE counters "
          f"{counts}, median step {step_ms[len(step_ms) // 2]:.1f} ms "
          f"({CAP_B / step_ms[len(step_ms) // 2] * 1e3:.2f} img/s), peak memory {peak:.2f} GiB "
          f"[{device_name}]")
    if not all(math.isfinite(x) for x in losses):
        fail(f"the caption step's losses are not finite: {losses}")
    if counts["calls"] != 26 * 6:
        fail(f"the MoE layers ran {counts['calls']} times in 6 steps, not {26 * 6}")
    return {"flips": flips, "step_ms": step_ms, "peak_gib": peak}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
        fail(f"{PACKAGE}/ is not beside chip_smoke.py; run it from the repository root")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    from multimodal_active_ai_tpu_torch import contrastive_learning as driver
    from multimodal_active_ai_tpu_torch.ops import bn_act as ba
    from multimodal_active_ai_tpu_torch.ops import conv1x1_stats as cs
    from multimodal_active_ai_tpu_torch.ops import cuda_build, retina
    from multimodal_active_ai_tpu_torch.ops import glimpse_sample as gs
    from multimodal_active_ai_tpu_torch.ops import stat_sums as ss
    from multimodal_active_ai_tpu_torch.utils import checkpoint as ckpt_mod

    # phase 1: build
    t0 = time.perf_counter()
    built = cuda_build.build(["glimpse_sample", "stat_sums", "conv1x1_stats", "bn_act"])
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for b in built.values():
        print(f"--- nvcc -Xptxas -v: {b.name} ---\n{b.log.strip()}")
    spilled = spills(built["conv1x1_stats"].log, "wgmma_kernel")
    if spilled:
        fail("B3's wgmma kernels spill registers:\n" + "\n".join(spilled))
    spilled = spills(built["bn_act"].log, "bn_act_")
    if spilled:
        fail("the bn_act kernels spill registers:\n" + "\n".join(spilled))
    device_name = gpu_name_and_power()
    print(f"gpu (name, power limit): {device_name}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: kernels against their plain versions
    b1, args = check_glimpse_sample(torch, gs, retina)
    rows = {"glimpse_sample": b1,
            "stat_sums": check_stat_sums(torch, ss),
            "conv1x1_stats": check_conv1x1_stats(torch, cs, ss.sm_count(0)),
            "hat_sample": check_hat_sample(torch, gs, args),
            "bn_act": check_bn_act(torch, ba)}
    check_small_step(torch, retina, gs)
    b_counters = {"glimpse_sample": gs.glimpse_sample, "stat_sums": ss.stat_sums,
                  "conv1x1_stats": cs.conv1x1_stats, "hat_sample": gs.hat_sample}
    # phases 2c, 3 and 3b-3f hold bn_act's four counts too; the later
    # phases hold B1-B4's alone
    counters = {**b_counters, **{k: getattr(ba, k) for k in BN_ACT_KERNELS}}
    check_odd_rows(torch, counters)

    # phase 3: the main path (norm 'bn'); 3b: the fused-statistics paths;
    # 3c, 3d, 3e and 3f: the probe, DETR, RLS and caption drivers from the
    # phase-3 checkpoint; 3g: the drivers on image files
    workdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        rows["glimpse_sample"]["launches"], rows["bn_act"]["launches"], bn_ms, simclr_ck = \
            run_main_path(torch, counters, driver, ckpt_mod, device_name, workdir)
        fused = run_stat_fusion_paths(torch, counters, driver, ckpt_mod, device_name)
        probe_launches, probe_ms = run_probe_path(torch, counters, simclr_ck, workdir,
                                                  device_name)
        detr_launches, detr_ms = run_detr_path(torch, counters, simclr_ck, workdir,
                                               device_name)
        rls_launches, rls_ms, dqn_ms, rls_peak = run_rls_path(torch, counters, simclr_ck,
                                                              workdir, device_name)
        t3f = time.perf_counter()
        cap_launches, cap_ms, cap_peak = run_caption_path(torch, counters, simclr_ck, workdir,
                                                          device_name)
        print(f"phase 3f (caption driver, its resume and 9 timed steps): "
              f"{time.perf_counter() - t3f:.1f} s")
        t3g = time.perf_counter()
        real = run_real_files_path(torch, b_counters, workdir, device_name)
        print(f"phase 3g (image folder, exactness, SimCLR, its resume, probe twice, "
              f"captions): {time.perf_counter() - t3g:.1f} s")
        t3h = time.perf_counter()
        dist = run_multi_rank_path(torch, simclr_ck, workdir, device_name)
        print(f"phase 3h (2-rank SimCLR, 1-rank NCCL, 2 vs 1 on the card, four drivers at 2 "
              f"ranks): {time.perf_counter() - t3h:.1f} s")
        t3i = time.perf_counter()
        run_jax_resume_path(torch, b_counters, driver, ckpt_mod, simclr_ck, workdir, device_name)
        print(f"phase 3i (JAX-layout checkpoint written, two resumes): "
              f"{time.perf_counter() - t3i:.1f} s")
        t3j = time.perf_counter()
        modes = run_retina_modes_path(torch, b_counters, device_name)
        print(f"phase 3j (canvas and fused retina on the card, their SimCLR steps): "
              f"{time.perf_counter() - t3j:.1f} s")
        t3k = time.perf_counter()
        drop = run_dropout_checks(torch, simclr_ck, workdir, device_name)
        state, images, gen = run_async_save_checks(torch, driver, ckpt_mod, workdir, device_name)
        run_profiling_checks(torch, state, images, gen, workdir, device_name)
        del state, images, gen
        gc.collect()
        torch.cuda.empty_cache()
        legacy_ms = run_model_checks(torch, device_name)
        examples = run_example_checks(torch, b_counters, workdir, device_name)
        run_unroll_check(torch, driver, workdir, device_name)
        print(f"phase 3k (dropout, async saver, profiling, legacy and 1-D ResNets, examples, "
              f"--unroll-fixations): {time.perf_counter() - t3k:.1f} s [{device_name}]")
        t3l = time.perf_counter()
        conv = run_convergence_checks(torch, b_counters, device_name)
        bn_update = check_bn_act_update(torch, ba, device_name)
        print(f"phase 3l (seven convergence cases, bn_fused case 1, ResNet50 bn vs bn_fused + "
              f"pallas, the loss curve on the CPU and the card, the fused BatchNorm's update): "
              f"{time.perf_counter() - t3l:.1f} s [{device_name}]")
        t3m = time.perf_counter()
        benched = run_bench_checks(torch, b_counters, workdir, device_name)
        print(f"phase 3m (the port's bench: five modes, MFU + trace, bn_fused + pallas, host "
              f"input): {time.perf_counter() - t3m:.1f} s [{device_name}]")
        t3n = time.perf_counter()
        learned = run_learning_checks(torch, b_counters, workdir, device_name)
        print(f"phase 3n (the learning run's part-1 and part-2 legs cut in epochs, the cue "
              f"probe, the RLS cue diagnostic, the BatchNorm statistics bench): "
              f"{time.perf_counter() - t3n:.1f} s [{device_name}]")
        t3o = time.perf_counter()
        run_caption_lm_path(torch, device_name)
        print(f"phase 3o (the generative caption step at the Kimi-VL-A3B cell's shapes): "
              f"{time.perf_counter() - t3o:.1f} s [{device_name}]")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    rows["conv1x1_stats"]["launches"] = fused["conv1x1_stats"]
    rows["stat_sums"]["launches"] = fused["stat_sums"]
    rows["hat_sample"]["launches"] = fused["hat_sample"]   # no production caller
    # phase 3l's counts: B1 in case 1, B2 and B3 in the ResNet50 bn_fused + pallas run alone
    for name, n in (("glimpse_sample", conv["b1"]), ("stat_sums", conv["b2"]),
                    ("conv1x1_stats", conv["b3"]), ("hat_sample", 0)):
        rows[name]["convergence_launches"] = n
    # bn_act: the main path's counts above, and phase 3l(e)'s F=10 step
    rows["bn_act"]["convergence_launches"] = bn_update["launches"]
    print(f"median train step ({ARCH}, b={BATCH}, F={FIXATIONS}, canvas {CANVAS}, bf16): "
          f"bn {bn_ms:.1f} ms, --stat-fusion pallas {fused['pallas_ms']:.1f} ms, "
          f"bn_fused + pallas {fused['bn_fused_ms']:.1f} ms [{device_name}]")
    print(f"median train step ({ARCH}, b={BATCH}, F={PROBE_FIXATIONS}, canvas {CANVAS}, bf16): "
          f"probe {probe_ms:.1f} ms ({BATCH / probe_ms * 1e3:.1f} img/s), DETR {detr_ms:.1f} "
          f"ms ({BATCH / detr_ms * 1e3:.1f} img/s); glimpse_sample launches probe "
          f"{probe_launches}, DETR {detr_launches} [{device_name}]")
    print(f"median RLS train step ({ARCH} DETR + ResNet18 DQN, b={BATCH}, F={PROBE_FIXATIONS}, "
          f"canvas {CANVAS}, bf16): {rls_ms:.1f} ms ({BATCH / rls_ms * 1e3:.1f} img/s), DQN "
          f"update (b=256) {dqn_ms:.1f} ms, peak memory {rls_peak:.2f} GiB; glimpse_sample "
          f"launches {rls_launches} a 3 + 1-step run [{device_name}]")

    print(f"median caption train step ({ARCH} float32 encoder, b={BATCH}, F={PROBE_FIXATIONS}, "
          f"canvas {CANVAS}; text tower at its defaults): {cap_ms:.1f} ms "
          f"({BATCH / cap_ms * 1e3:.1f} img/s), peak memory {cap_peak:.2f} GiB; glimpse_sample "
          f"launches {cap_launches} a driver run [{device_name}]")

    print(f"median driver step on image files ({ARCH}, b={BATCH}, canvas {CANVAS}, bf16; host "
          f"clock of the driver's -p 1 lines, the loader in the loop): SimCLR F={FIXATIONS} "
          f"cache cold {real['simclr_cold_ms']:.1f} ms {[round(t) for t in real['simclr_cold']]}"
          f", cache warm {real['simclr_warm_ms']:.1f} ms "
          f"{[round(t) for t in real['simclr_warm']]}, synthetic (phase 3) {bn_ms:.1f} ms; "
          f"probe F={PROBE_FIXATIONS} cache off {real['probe_cold_ms']:.1f} ms "
          f"{[round(t) for t in real['probe_cold']]}, cache warm {real['probe_warm_ms']:.1f} ms "
          f"{[round(t) for t in real['probe_warm']]}, synthetic (phase 3c) {probe_ms:.1f} ms; "
          f"peak memory {real['peak_gib']:.2f} GiB in the SimCLR run [{device_name}]")

    label = " (2 ranks on one card: not a scaling figure)" if "share" in dist["how"] else ""
    print(f"2-rank SimCLR step ({dist['how']}; {ARCH}, b={BATCH} a rank, F={FIXATIONS}, canvas "
          f"{CANVAS}, bf16){label}: {dist['step_ms']:.1f} ms a rank, "
          f"{2 * BATCH / dist['step_ms'] * 1e3:.1f} img/s global, peak memory "
          f"{dist['peak_gib']:.2f} GiB a rank; 1-rank step (phase 3) {bn_ms:.1f} ms "
          f"[{device_name}]")

    print(f"retina modes ({ARCH}, b={BATCH}, F={FIXATIONS}, canvas {CANVAS}, bf16): SimCLR "
          f"step fused {modes['fused'][0]:.1f} ms ({modes['fused'][1]:.2f} GiB), canvas "
          f"{modes['canvas'][0]:.1f} ms ({modes['canvas'][1]:.2f} GiB), matmul (phase 3) "
          f"{bn_ms:.1f} ms; a view: fused {modes['view_ms']['fused']:.2f} ms, canvas "
          f"{modes['view_ms']['canvas']:.2f} ms [{device_name}]")

    print(f"last modules (phase 3k): glimpse_sample launches with dropout 0.1 in the DETR, RLS "
          f"and caption driver runs {detr_launches}, {rls_launches}, {cap_launches} (expected 4, "
          f"10, 17); device busy a step with dropout 0.1 vs 0: DETR {drop['detr_0.1'][1]:.2f} "
          f"vs {drop['detr_0.0'][1]:.2f} ms, caption {drop['caption_0.1'][1]:.2f} vs "
          f"{drop['caption_0.0'][1]:.2f} ms; legacy_resnet50 train step (b={BATCH}, 30x30x15, bf16) "
          f"{legacy_ms:.1f} ms; example twins' glimpse_sample launches {examples} "
          f"[{device_name}]")

    print(f"convergence (phase 3l): the seven cases met the JAX package's thresholds on the "
          f"card: " + "; ".join(f"{k} {v[0]} {v[1]:.1f} s" for k, v in conv["cases"].items())
          + f"; bn_fused case 1 top-1 {conv['bn_fused']:.4f}; ResNet50 bn_fused + pallas vs "
          f"bn from one state {conv['fused_rel']:.3e}, trained apart {conv['fused_drift']:.3e}; "
          f"loss curve cuda vs cpu {conv['curve_rel']:.3e} over {conv['curve_steps']} steps "
          f"[{device_name}]")

    print("port bench (phase 3m; best / median img/s/chip, peak GiB): " + "; ".join(
        f"{k} {r['value']} / {r.get('median_img_s_chip', '-')}, {g:.2f}"
        for k, (r, g) in benched.items()) + f" [{device_name}]")

    print("learning run (phase 3n; best %, chance %): " + "; ".join(
        f"{k} " + ", ".join(f"{m} {v:.2f}" for m, v in leg["best"].items())
        + f" ({leg['chance']:.2f})" for k, leg in learned["legs"].items())
        + "; cue probe " + ", ".join(f"{k} {v:.3f}" for k, v in learned["cue"].items())
        + f"; RLS cue diagnostic CE {learned['diag'][0]:.4f} -> {learned['diag'][1]:.4f}; "
        f"BatchNorm statistics, one pass: bn {learned['bn']['bn_ms']:.4f} ms, B2 "
        f"{learned['bn']['b2_ms']:.4f} ms, bound {learned['bn']['bound_ms']:.4f} ms "
        f"[{device_name}]")

    # phase 4: results
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "convergence_launches"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def caption_lm_only() -> int:
    """``--caption-lm``: phase 3o alone."""
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    device_name = gpu_name_and_power()
    print(f"gpu (name, power limit): {device_name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    run_caption_lm_path(torch, device_name)
    print(f"phase 3o: {time.perf_counter() - t0:.1f} s [{device_name}]")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-job"]:
        sys.exit(rank_job(sys.argv[2], sys.argv[3], sys.argv[4:]))
    if sys.argv[1:2] == ["--caption-lm"]:
        sys.exit(caption_lm_only())
    sys.exit(main())
