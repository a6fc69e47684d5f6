#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training (CE, BACS, MiB, PLOP, ER, SDR
and iCaRL; DeepLabV3, UNet and TranSeg; gradient accumulation and stage
remat), eval, continual-trainer and protocol-runner paths on one NVIDIA GPU
(H100).

    python3 chip_smoke.py [--seed 0]
    python3 chip_smoke.py --family-times [--package-root DIR]
    python3 chip_smoke.py --bacs-busy [--package-root DIR]
    python3 chip_smoke.py --transeg

Run from the root of a checkout.  It builds the hand-written kernels from
``bacs_tpu_torch/csrc`` (nvcc, into ``build/``) and Triton at first use
(Triton's cache also under ``build/``), then:

1. prints the environment, the card's ``nvidia-smi`` name and power limit,
   the build time and the registers and spills of the upsample+loss
   family's kernels and K12's (``nvcc -Xptxas -v``);
2. holds the eval-ABN kernel (K5, Triton) against its plain PyTorch version
   at the ResNet-101 serving forward's shapes at batch 16;
3. holds the upsample+argmax+confidence kernel (K10, CUDA) against its plain
   version, at the serving shapes and at channel counts at and across its
   register chunks (16, 17, 24, 25, 33), with exact ties (inputs on a few
   levels, scale 16) where the two must pick the same first channel;
4. runs the full DeepLabV3-ResNet-101 Predictor at 512^2, batch 1, in f32 on
   the card (kernels) and on the CPU (plain versions) and compares them;
5. serves bf16 batches through ``Predictor.predict_many`` (16 x 8) and
   ``Predictor.predict`` (1 x 20) with the launch counters reset just
   before, and asserts 107 K5 launches and 1 K10 launch per forward;
   then times each kernel against its plain version at the forward's
   shapes, and profiles two served batches (a table of device time by
   operator and kernel; device busy time and idle share);
6. holds the upsample+CE kernels (K1 forward and backward, CUDA) against
   their plain versions at the training shape [16,32,32,21] -> 512^2 and
   odd shapes, bf16 and f32, with ~5 % ignored labels;
7. holds the upsample+argmax+confusion kernel (K2, CUDA) against its plain
   version at the same shapes;
8. runs one f32 CE train step of DeepLabV3-ResNet-101 at 4 x 128^2 on the
   card and on the CPU (TF32 off), with identity activations and with the
   configured leaky ones, and compares loss, gradients, the parameters
   after the SGD update and the running statistics (every tensor to f32
   rounding where the network is smooth);
9. trains in bf16 (f32 master weights) at 512^2, batch 16, through
   ``train.step.make_steps`` on seeded synthetic batches whose labels are
   learnable from the colours: 2 warm-up and 10 timed steps with the
   launch counters reset just before the timed ones; asserts 1 K1 forward,
   1 K1 backward and 107 train-ABN applies per step and a falling loss,
   prints the curve, the median img/s and the peak memory, and profiles
   two steps (device time by kernel, busy and idle share);
10. runs bf16 eval steps at 512^2, batch 16: asserts 107 eval-ABN (K5),
   1 K1 forward and 1 K2 launch per step and that the confusion matrix
   counts every valid pixel, and times the step (wall and device busy);
11. holds the class-weighted upsample+CE kernels (K4 forward and backward,
   CUDA) against their plain versions at the dark++ replay shape
   [12,32,32,17] -> 512^2 with its weights (0 for background and the new
   class), at odd shapes, bf16 and f32, and with all-zero weights;
12. holds the BACS seen-weighted upsample+CE kernels (K3 forward and
   backward, CUDA) at the main batch's [16,32,32,17] -> 512^2 and odd
   shapes, with ``max_seen`` on both sides of the threshold, ukd on and
   off, old classes C - 1, bf16 and f32;
13. runs one f32 BACS step at task 1 (RN101 4 x 128^2, replay 4 from 8
   slots) on the card and on the CPU (TF32 off), the random draws injected
   identically, and compares it as phase 8 does, prototypes included;
14. at 512^2 in bf16: ``end_task`` of task 0 over 20 synthetic batches of 16
   (the prototype sweep, the previous-model snapshot and the 300-slot
   reservoir fill in train mode, evictions included), then task-1 BACS
   steps (``bacs_plus_bg.yaml``: replay 2 x 12, the detector, the teacher
   distillation): 2 warm-up and 6 timed with the counters reset just
   before, asserting per step 1 K3 and 1 K4 forward and backward, no K1,
   321 train-ABN applies and 107 eval-ABN (K5, the previous model); the
   median img/s of the main batch, the peak memory, a two-step profile by
   kernel, and the device time of each part of the step alone (the three
   network forwards and backwards, the previous model, the teacher
   distillation, the detector, K3/K4, SGD);
15. one eval step at task 1: 107 K5, 1 K1 forward and 1 K2 per step, every
   valid pixel counted, and its device busy time;
16. holds MiB's kernels, the unbiased upsample+CE (K6) and the unbiased KD
   of an upsampled student/teacher pair (K7), forward and backward,
   against their plain versions at the step's [12,32,32,17] (teacher 16
   channels) -> 512^2 and odd shapes, bf16 and f32, KD alpha 1 and 0.7;
17. holds PLOP's kernels, K1's backward with a per-image cotangent (K8; and
   K1's scalar case bit for bit) and the pseudo-labels (K9; labels equal
   wherever no threshold or top-2 tie lies within 1e-5), the same way, K9
   also at channel counts across its register chunks, with int64 labels,
   another ignore index and an image whose labels are all new;
18. runs one f32 task-1 MiB and PLOP step (RN101 4 x 128^2, after the
   MultiHead imprinting; PLOP's thresholds set clear of every pixel's
   entropy) on the CPU and on the card (TF32 off) and compares them as
   phase 13 does;
19. at 512^2 in bf16, batch 12 (``cont_15_1.yaml``), per method: ``end_task``
   of task 0 (the previous-model snapshot), the imprinting, for PLOP
   ``begin_task`` over 10 batches (timed), then 2 warm-up and 6 timed
   task-1 steps with the counters reset just before, asserting per step
   (MiB) 1 K6 and 1 K7 each way or (PLOP) 1 K9, 1 K1 forward and 1 K8,
   and 107 train-ABN and 107 K5 (the previous model), a finite loss; the
   median img/s, the peak memory and a two-step profile by kernel kind;
20. the task-1 eval steps of both: 107 K5, 1 K1 forward and 1 K2 per step;
21. holds the fused stem's kernels (K12: ABN apply + leaky + 3x3/2 max-pool,
   forward and backward, CUDA) against their plain versions at the stem's
   [16|12, 256, 256, 64], two small odd-sized cases and an input on three
   levels (ties), f32 (value rtol 2e-3, gradient 5e-2) and bf16 (values
   exact, gradients exact outside windows with a near tie), and that a
   CUDA tensor the kernel does not take raises;
22. phase 8 with ``fused_stem``: one f32 train step card against CPU, K12
   launched once each way on the card;
23. the bf16 512^2 CE step at batch 16 with the fused stem on against off
   (phase 9's configuration), timed in turns on the same batches: median
   wall, busy time, peak memory, the stem's kernels' share, and per step 1
   K12 each way and 106 train-ABN applies (off: none and 107);
24. the continual protocol through the CLI's ``bacs_tpu_torch.main.train``
   in-process: ``conf/bacs/bacs_plus_config`` with ``der_15_1_bg``,
   ``bacs_plus_bg`` and the fused stem, DeepLabV3-ResNet-101 at 512^2 in
   bf16, batch 12, on the synthetic source at VOC's 21 classes (400 train
   and 48 validation images), one step per new class: all 6 tasks, BACS's
   ``end_task`` filling the 300-slot buffer, checkpoints under ``build/``,
   the run stopped after task 1's first mid-task checkpoint and resumed
   (a new Trainer on the first run's DataModule: the same images);
   asserts the metric keys, 1 K12 each way per train-mode network pass of
   every train step (1 pass at task 0, 3 later) and a finite final mIoU;
   prints the seconds of each task's parts, ``Trainer.throughput``, the
   checkpoints' sizes and times, and the last task's device idle share;
25. runs one f32 task-1 step of ER, SDR and iCaRL (RN101 4 x 128^2, after
   task 0's ``end_task`` and the imprinting; ER's replay draws injected)
   on the CPU and on the card (TF32 off), with identity and leaky
   activations, and compares them as phase 13 does, with SDR's class
   prototypes and ER's buffer importances;
26. at 512^2 in bf16, batch 12 (``conf/experiments/loss/{er,sdr,icarl}.yaml``,
   ``cont_15_1.yaml``), per method: task 0's ``end_task`` (ER's buffer
   population, timed), the imprinting, the task-1 eval steps (107 K5 and 1
   K2 each, with K1's forward for ER and K6's for SDR; finite losses), then
   2 warm-up and 4 timed task-1 steps with the counters reset just before,
   asserting per step the launches the code implies (ER: 1 K1 and 1 K4
   each way and 214 train-ABN; SDR: 1 K6 and 1 K7 each way, 107 train-ABN
   and 107 K5; iCaRL: 107 train-ABN and 107 K5, no upsample kernel), a
   finite loss, the median wall, the peak memory and a two-step profile by
   kernel kind;
27. the 15-1 flagship protocol through ``bacs_tpu_torch.protocol_compare``
   in-process for ER, SDR and iCaRL, cut to one epoch a task and 96 / 64
   images: the records' keys, one Avg-IoU per task, finite mIoUs and a
   finite loss at every train step;
28. one f32 CE train step of UNet-4 at 4 x 128^2 on the card and on the
   CPU (TF32 off), held as phase 8 holds the leaky step (ReLU kinks), the
   running statistics to 1e-4, then the eval step on both;
29. UNet-5 at the shipped width (``conf/experiments/network/unet.yaml``,
   64-512 channels, bilinear), 512^2, bf16: CE train steps at batch 16 (a
   falling loss, no kernel launched, wall, peak and a profile by kernel
   kind), eval steps (busy time), serving through the Predictor (exactly
   one K10, at scale 1, and no K5 per forward; img/s; K10 at
   [16, 512, 512, 21] held to its plain version and timed beside it and
   its bound) and a task-1 BACS step with the detector (batch 8, replay
   2 x 4);
30. gradient accumulation over 2 mini-steps: a pair of f32 RN101 mini-steps
   at 4 x 128^2 card against CPU, held as phase 8; then bf16 CE at 512^2,
   batch 8, one optimizer step per two mini-steps asserted, busy, peak;
31. stage remat: RN101 bf16 CE at 512^2, batch 16, ``remat=false`` and
   ``remat=true`` in turns (off, on, on, off): the first step's loss equal,
   gradients within bf16 rounding, running statistics updated once; the
   peak memory, busy time and train-ABN launches of each turn;
32. the 3-task protocol (UNet-3) through ``bacs_tpu_torch.protocol_compare``
   in-process for CE, MiB and BACS at one epoch a task: the records' keys,
   3 tasks, finite mIoUs, no kernel launched;
33. f32 TranSeg steps at RN101 4 x 128^2 with the shipped head (hidden 256,
   8 heads, 2 layers, feed-forward 2048) on the card and on the CPU (TF32
   off), identity and leaky activations, held as phase 8: a task-0 CE step
   (16 of 21 class tokens) and the eval step before it, then a task-1 BACS+ step after
   task 0's ``end_task`` with the ``mean`` token growth, 17 tokens on the
   model and the previous model, and the detector (draws injected as [13]);
34. TranSeg at the shipped width, 512^2, bf16: CE train steps at batch 16
   (1 K1 each way and 104 train-ABN a step, a falling loss, wall, busy,
   idle share, peak, a profile by kind), eval steps (104 K5, 1 K1 forward,
   1 K2), serving through the Predictor (104 K5 and 1 K10 a forward, on
   float32 logits), K1, K2, K10, K3 and K4 on float32 input at the path's
   shapes held to their plain versions and timed beside their bounds, and
   task-1 BACS+ steps at 12 + 2 x 12 replay with the detector after task
   0's ``end_task`` and the token growth (1 K3 and 1 K4 each way, 312
   train-ABN and 104 K5 a step);
35. ``conf/experiments/bacs_transformer_config`` through
   ``bacs_tpu_torch.main.train`` in-process with [24]'s synthetic source
   (200 training images) and the fused stem, all 6 tasks, no checkpoints: the token growth and
   the class counts checked at every boundary, a finite final mIoU, the
   seconds per task and the launches;
t. times K1-K4, K6-K10 and K12 at the main path's shapes beside their plain
   versions and their times before each one's redesign (K12 also beside
   the unfused ABN + max-pool pair, K1 and K4 beside the unfused
   ``F.interpolate`` + ``F.cross_entropy`` pair, K2 beside the unfused
   ``F.interpolate`` + ``argmax`` + ``torch.bincount`` trio and also on
   logits whose argmax follows the label blocks, so that most warps of 32
   kept pixels fill one bin), computes every kernel's bound from its
   inputs (bytes, f32 operations and special-function operations), and
   holds two launches of each staged kernel (K1, K3, K4, K6, K7 forward
   and backward, K2, K8, K9, K10) and of K12 bit-equal.

Every profiled window logs the card's SM clock over it (``[clock]``,
``nvidia-smi`` sampling), beside the busy time it gives.

``--transeg`` only builds and runs phases [33]-[35].
``--family-times`` only builds and times the redesigned kernels (K1-K4,
K6-K10 and K12) at the main path's shapes (one JSON line), and
``--bacs-busy`` the task-1 BACS step's device busy time (phase 14's
set-up); with ``--package-root`` the port of another checkout, so that
two versions (e.g. the parent commit unpacked under ``build/``) are timed
in one call, in turns.

Weights are random, made from ``--seed``.  A failed check raises, so the
script exits nonzero and prints no result.  The last three lines are a
JSON object of every kernel's launches, error, times and bound on this
card, the card's ``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_CLASSES = 21  # conf/bacs/dataset/voc.yaml
ADE_CLASSES = 150  # ADE20K's classes
N_TASKS = 6  # VOC 15-1 with background: 16 classes, then 5 tasks of 1
CROP = 512
BATCH = 16
NETWORK_YAML = "conf/bacs/network/deep_lab.yaml"
K5_SHAPES = [(16, 256, 256, 64), (16, 128, 128, 256), (16, 64, 64, 512),
             (16, 32, 32, 1024), (16, 32, 32, 2048), (16, 1, 1, 256)]
K10_CASES = [((16, 32, 32, 21), (512, 512)), ((1, 32, 32, 21), (512, 512)),
             ((2, 33, 47, 21), (261, 373)), ((2, 8, 8, 150), (128, 128))]
# K9 and K10 at channel counts at and across the register chunks of
# csrc/upsample_stage.cuh (16, 24, then 32 a chunk)
CHUNK_CHANNELS = (16, 17, 24, 25, 33)
# K4 at the dark++ replay batch, K3 at the main batch (17 classes at task 1)
WEIGHTED_CASES = [((12, 32, 32, 17), (512, 512)), ((16, 32, 32, 17), (512, 512)),
                  ((2, 33, 47, 17), (261, 373)), ((2, 5, 7, 6), (37, 51))]
ABN_PER_FORWARD = 107  # stem 1 + 33 bottlenecks x 3 + 4 proj_bn + ASPP 3
OPTIMIZER_YAML = "conf/bacs/optimizer/nesterov.yaml"
SCHEDULER_YAML = "conf/bacs/scheduler/poly.yaml"
MAX_ITERS = 20000  # poly horizon: about 30 VOC epochs of 10582 images at batch 16
TRAIN_STEPS, WARMUP_STEPS, EVAL_STEPS = 10, 2, 3
# the H100 SXM's published peaks (dense f32 on CUDA cores, HBM3 bandwidth)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# exponentials, logarithms and reciprocals run on the special-function
# units: 16 per clock per SM at compute capability 9.0 (the CUDA C++
# Programming Guide's throughput table), 132 SMs at the 1.98 GHz boost clock
SFU_OPS_PER_S = 16 * 132 * 1.98e9


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(fields: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def sm_clock(label: str):
    """Logs the card's SM clock over the block: ``nvidia-smi`` samples
    ``clocks.sm`` every 100 ms while it runs (median and range), beside
    ``clocks.max.sm``; a block shorter than the first sample reads the
    clock once after it.  A busy time is read against the clock the card
    ran at: cards of one kind and power limit differ in it between calls."""
    proc = subprocess.Popen(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield
    finally:
        proc.terminate()
        try:
            out = proc.communicate(timeout=30)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            out = proc.communicate()[0]
        rows = [[int(v) for v in line.split(",")] for line in out.splitlines()
                if line.replace(",", "").replace(" ", "").isdigit()]
        if rows:
            mhz = sorted(r[0] for r in rows)
            log(f"[clock] {label}: SM clock median {mhz[len(mhz) // 2]} MHz (min {mhz[0]}, "
                f"max {mhz[-1]}; {len(mhz)} samples, 100 ms apart) of max {rows[0][1]} MHz")
        else:
            log(f"[clock] {label}: SM clock, max SM clock just after: "
                f"{nvidia_smi('clocks.sm,clocks.max.sm')}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` by CUDA events over ``iters`` calls launched from
    the host: where a call's host cost exceeds its device time, this is
    the host's launch rate."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn``: ``iters`` calls captured in one CUDA
    graph and replayed, so no host launch cost shows."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- checks


def check_abn(shape, slope, dtype, device, seed=0) -> float:
    """K5 against its plain version; returns the max abs error."""
    from bacs_tpu_torch.ops.abn_core import abn_eval_plain, fused_abn_eval

    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=g, device=device) * 2).to(dtype)
    mean = torch.rand(c, generator=g, device=device) - 0.5
    var = torch.rand(c, generator=g, device=device) * 2 + 0.3
    scale = torch.rand(c, generator=g, device=device) * 3 - 1.5
    bias = torch.rand(c, generator=g, device=device) - 0.5
    got = fused_abn_eval(x, mean, var, scale, bias, 1e-5, slope)
    ref = abn_eval_plain(x, mean, var, scale, bias, 1e-5, slope)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    else:
        # one bf16 ulp (rtol 8e-3); near 0 the f32 terms cancel and the two
        # f32 roundings (FMA or not) differ by ~1e-8, so keep the f32 atol
        torch.testing.assert_close(got.float(), ref.float(), rtol=8e-3, atol=1e-5)
    return float((got.float() - ref.float()).abs().max())


def check_argmax(shape, out_hw, dtype, device, seed=0, levels=False) -> float:
    """K10 against its plain version; returns the max abs confidence error.
    With ``levels`` the logits are integers in [-3, 3], so most pixels tie
    within a register chunk and across chunks; where the interpolation
    weights are exact in f32 (power-of-two scales) the two upsample alike
    and their preds must be equal at every pixel, ties included (the first
    channel that reaches the max)."""
    from bacs_tpu_torch.ops.upsample_argmax import (
        argmax_conf_from, upsampled_argmax_conf)
    from bacs_tpu_torch.ops.upsample_tiles import kmats

    g = torch.Generator(device=device).manual_seed(seed)
    if levels:
        sem = torch.randint(-3, 4, shape, generator=g, device=device).to(dtype)
    else:
        sem = (torch.randn(shape, generator=g, device=device) * 4).to(dtype)
    preds, conf = upsampled_argmax_conf(sem, out_hw)
    kh, kw = (torch.from_numpy(k).to(device) for k in kmats(shape, out_hw))
    up = torch.einsum("Hh,nhwc->nHwc", kh, sem.float())
    up = torch.einsum("Ww,nHwc->nHWc", kw, up)
    ref_p, ref_c = argmax_conf_from(up)
    torch.cuda.synchronize()
    assert preds.dtype == torch.uint8 and conf.dtype == torch.float16
    assert preds.shape == ref_p.shape == (shape[0],) + tuple(out_hw)
    top2 = up.topk(2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > 1e-4
    same = preds == ref_p
    assert bool(same[decisive].all()), "preds differ at a decisive pixel"
    assert float(same.float().mean()) >= 0.9999
    if levels:
        assert bool(same.all()), "preds differ at a tie"
    err = float((conf.float() - ref_c.float()).abs().max())
    assert err <= 1e-3, f"confidence error {err}"
    return err


def seeded_labels(n, out_hw, c, device, seed=0, ignore_share=0.05):
    """int32 labels in [0, c) with about ``ignore_share`` of them 255."""
    g = torch.Generator(device=device).manual_seed(seed + 1)
    labels = torch.randint(0, c, (n, *out_hw), generator=g, device=device,
                           dtype=torch.int32)
    ignore = torch.rand((n, *out_hw), generator=g, device=device) < ignore_share
    return torch.where(ignore, torch.full_like(labels, 255), labels)


def check_ce(shape, out_hw, dtype, device, seed=0):
    """K1 forward and backward against their plain versions; returns the
    max abs errors of the per-image loss sums and of the gradient, each
    also relative to the largest reference value."""
    from bacs_tpu_torch.ops.upsample_ce import (
        ce_dsem, ce_dsem_plain, ce_sums_per_image, ce_sums_plain)

    g = torch.Generator(device=device).manual_seed(seed)
    sem = (torch.randn(shape, generator=g, device=device) * 3).to(dtype)
    labels = seeded_labels(shape[0], out_hw, shape[-1], device, seed)
    loss, count = ce_sums_per_image(sem, labels, out_hw)
    ref_loss, ref_count = ce_sums_plain(sem, labels, out_hw)
    scale = (1.0 / ref_count.sum()).reshape(())
    dsem = ce_dsem(sem, labels, out_hw, scale)
    ref_dsem = ce_dsem_plain(sem, labels, out_hw, scale)
    torch.cuda.synchronize()
    assert torch.equal(count, ref_count), "valid counts differ"
    assert dsem.dtype == dtype and dsem.shape == sem.shape
    val_abs = float((loss - ref_loss).abs().max())
    grad_abs = float((dsem.float() - ref_dsem.float()).abs().max())
    val_err = val_abs / float(ref_loss.abs().max())
    grad_err = grad_abs / float(ref_dsem.float().abs().max())
    # the TPU kernels' tolerances against their fallbacks (value rtol 2e-3,
    # gradient 5e-2 of the largest, scripts/check_kernels_tpu.py:96-97) in
    # bf16, where the gradient is rounded to bf16 after sums in another
    # order; f32 differs only by the order of the sums
    val_tol, grad_tol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-3, 5e-2)
    assert val_err <= val_tol, f"K1 value error {val_err}"
    assert grad_err <= grad_tol, f"K1 gradient error {grad_err}"
    return dict(val_abs=val_abs, grad_abs=grad_abs, val_rel=val_err,
                grad_rel=grad_err)


def _rel_errors(val, ref_val, dsem, ref_dsem, dtype, name):
    """Max abs errors of a loss value and its gradient, each also relative to
    the largest reference value, held to the tolerances of ``check_ce``."""
    val_abs = float((val - ref_val).abs().max())
    grad_abs = float((dsem.float() - ref_dsem.float()).abs().max())
    val_err = val_abs / max(float(ref_val.abs().max()), 1e-30)
    grad_err = grad_abs / max(float(ref_dsem.float().abs().max()), 1e-30)
    val_tol, grad_tol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-3, 5e-2)
    assert val_err <= val_tol, f"{name} value error {val_err}"
    assert grad_err <= grad_tol, f"{name} gradient error {grad_err}"
    return dict(val_abs=val_abs, grad_abs=grad_abs, val_rel=val_err, grad_rel=grad_err)


def beta_weights(c, device):
    """The dark++ replay term's class weights at c = old + 1 classes: 1 for
    the old foreground classes, 0 for background and the new class."""
    ch = torch.arange(c, device=device)
    return ((ch >= 1) & (ch < c - 1)).float()


def check_wce(shape, out_hw, dtype, device, weights=None, seed=0):
    """K4 forward and backward against their plain versions (``weights``
    default: ``beta_weights``); returns the errors as ``check_ce``.  With
    all-zero weights both sums and the gradient must be exactly 0."""
    from bacs_tpu_torch.ops.upsample_ce import (
        wce_dsem, wce_dsem_plain, wce_sums, wce_sums_plain)

    g = torch.Generator(device=device).manual_seed(seed)
    sem = (torch.randn(shape, generator=g, device=device) * 3).to(dtype)
    labels = seeded_labels(shape[0], out_hw, shape[-1], device, seed)
    w = beta_weights(shape[-1], device) if weights is None else weights
    loss, wsum = wce_sums(sem, labels, w, out_hw)
    ref_loss, ref_wsum = wce_sums_plain(sem, labels, w, out_hw)
    scale = (1.0 / ref_wsum.clamp(min=1e-8)).reshape(())
    dsem = wce_dsem(sem, labels, w, out_hw, scale)
    ref_dsem = wce_dsem_plain(sem, labels, w, out_hw, scale)
    torch.cuda.synchronize()
    assert dsem.dtype == dtype and dsem.shape == sem.shape
    assert float((wsum - ref_wsum).abs()) <= 1e-5 * float(ref_wsum), "weight sums differ"
    if float(w.abs().max()) == 0.0:
        assert float(loss) == float(wsum) == 0.0 and not bool(dsem.any())
        return dict(val_abs=0.0, grad_abs=0.0, val_rel=0.0, grad_rel=0.0)
    return _rel_errors(loss, ref_loss, dsem, ref_dsem, dtype, "K4")


def check_bacs(shape, out_hw, dtype, device, ukd=True, seed=0):
    """K3 forward and backward against their plain versions, with
    ``old_classes`` = C - 1, about a third of the labels background and
    ``max_seen`` uniform in [0, 1) (both sides of the 0.5 threshold);
    returns the errors as ``check_ce``.  The logits stay within a range
    where the kernel's eps 1e-30 (which the plain version lacks) is
    invisible."""
    from bacs_tpu_torch.ops.upsample_ce import (
        bacs_dsem, bacs_dsem_plain, bacs_sum, bacs_sum_plain)

    g = torch.Generator(device=device).manual_seed(seed)
    n, c = shape[0], shape[-1]
    sem = (torch.randn(shape, generator=g, device=device) * 3).to(dtype)
    labels = seeded_labels(n, out_hw, c, device, seed)
    bg = torch.rand(labels.shape, generator=g, device=device) < 0.3
    labels = torch.where(bg & (labels != 255), torch.zeros_like(labels), labels)
    max_seen = torch.rand(labels.shape, generator=g, device=device)
    args = (c - 1, 2.0, 0.5, ukd)
    total = bacs_sum(sem, labels, max_seen, out_hw, *args)
    ref_total = bacs_sum_plain(sem, labels, max_seen, out_hw, *args)
    scale = torch.tensor(1.0 / labels.numel(), device=device)
    dsem = bacs_dsem(sem, labels, max_seen, out_hw, scale, *args)
    ref_dsem = bacs_dsem_plain(sem, labels, max_seen, out_hw, scale, *args)
    torch.cuda.synchronize()
    assert dsem.dtype == dtype and dsem.shape == sem.shape
    return _rel_errors(total, ref_total, dsem, ref_dsem, dtype, "K3")


def check_uce(shape, out_hw, dtype, device, seed=0):
    """K6 forward and backward against their plain versions, old classes C -
    1, about a third of the labels background; returns the errors as
    ``check_ce``.  The gradient's scale is MiB's 1 / (N H W)."""
    from bacs_tpu_torch.ops.upsample_ce import (
        uce_dsem, uce_dsem_plain, uce_sums, uce_sums_plain)

    g = torch.Generator(device=device).manual_seed(seed)
    n, c = shape[0], shape[-1]
    sem = (torch.randn(shape, generator=g, device=device) * 3).to(dtype)
    labels = seeded_labels(n, out_hw, c, device, seed)
    bg = torch.rand(labels.shape, generator=g, device=device) < 0.3
    labels = torch.where(bg & (labels != 255), torch.zeros_like(labels), labels)
    loss, count = uce_sums(sem, labels, out_hw, c - 1)
    ref_loss, ref_count = uce_sums_plain(sem, labels, out_hw, c - 1)
    scale = torch.tensor(1.0 / labels.numel(), device=device)
    dsem = uce_dsem(sem, labels, out_hw, scale, c - 1)
    ref_dsem = uce_dsem_plain(sem, labels, out_hw, scale, c - 1)
    torch.cuda.synchronize()
    assert float(count) == float(ref_count), "valid counts differ"
    assert dsem.dtype == dtype and dsem.shape == sem.shape
    return _rel_errors(loss, ref_loss, dsem, ref_dsem, dtype, "K6")


def check_ukd(shape, out_hw, dtype, device, alpha=1.0, seed=0, c_old=None):
    """K7 forward and backward against their plain versions: a student of
    C channels and a teacher of ``c_old`` (default C - 1); returns the
    errors as ``check_ce``.  The gradient's scale is MiB's -1 / (N H W)."""
    from bacs_tpu_torch.ops.upsample_ce import (
        ukd_dsem, ukd_dsem_plain, ukd_sum, ukd_sum_plain)

    g = torch.Generator(device=device).manual_seed(seed)
    sem = (torch.randn(shape, generator=g, device=device) * 3).to(dtype)
    c_old = shape[-1] - 1 if c_old is None else c_old
    sem_old = (torch.randn((*shape[:3], c_old), generator=g, device=device) * 3).to(dtype)
    total = ukd_sum(sem, sem_old, out_hw, alpha)
    ref_total = ukd_sum_plain(sem, sem_old, out_hw, alpha)
    scale = torch.tensor(-1.0 / (shape[0] * out_hw[0] * out_hw[1]), device=device)
    dsem = ukd_dsem(sem, sem_old, out_hw, scale, alpha)
    ref_dsem = ukd_dsem_plain(sem, sem_old, out_hw, scale, alpha)
    torch.cuda.synchronize()
    assert dsem.dtype == dtype and dsem.shape == sem.shape
    return _rel_errors(total, ref_total, dsem, ref_dsem, dtype, "K7")


def check_ce_per_image(shape, out_hw, dtype, device, seed=0):
    """K8 against its plain version with a per-image cotangent (PLOP's
    factor over N H W); and K8 with every image's g equal to K1's scalar
    gives K1's gradient bit for bit.  Returns the gradient's errors."""
    from bacs_tpu_torch.ops.upsample_ce import (
        ce_dsem, ce_dsem_per_image, ce_dsem_per_image_plain)

    g = torch.Generator(device=device).manual_seed(seed)
    n = shape[0]
    sem = (torch.randn(shape, generator=g, device=device) * 3).to(dtype)
    labels = seeded_labels(n, out_hw, shape[-1], device, seed)
    gvec = torch.rand(n, generator=g, device=device) / (n * out_hw[0] * out_hw[1])
    dsem = ce_dsem_per_image(sem, labels, out_hw, gvec)
    ref = ce_dsem_per_image_plain(sem, labels, out_hw, gvec)
    same_g = gvec[:1].reshape(())
    assert torch.equal(ce_dsem(sem, labels, out_hw, same_g),
                       ce_dsem_per_image(sem, labels, out_hw, same_g.expand(n).contiguous()))
    torch.cuda.synchronize()
    assert dsem.dtype == dtype and dsem.shape == sem.shape
    grad_abs = float((dsem.float() - ref.float()).abs().max())
    grad_rel = grad_abs / max(float(ref.float().abs().max()), 1e-30)
    assert grad_rel <= (1e-4 if dtype == torch.float32 else 5e-2), f"K8 error {grad_rel}"
    return dict(grad_abs=grad_abs, grad_rel=grad_rel)


def check_pseudo(shape, out_hw, dtype, device, seed=0, labels_dtype=torch.int32,
                 ignore_index=255, new_image=False):
    """K9 against its plain version: a teacher of C_old = C channels,
    labels in [0, C] (C the new class) with ignored ones (255), each class's
    threshold the mean of two random pixels' entropies (not the entropy of
    a pixel, which the clamped upsample repeats at the borders),
    max_entropy log(C + 1); ``ignore_index`` the label of a dropped pixel,
    ``new_image`` the first image's labels all C.  A
    pixel within 1e-5 of its threshold, or whose top two logits are within
    1e-5, may take the other branch: the labels agree at every other pixel,
    and such flips stay under 1e-4 of the pixels; den is equal, num within
    the flips.  Returns the number of pixels labelled differently."""
    from bacs_tpu_torch.ops.losses import pixel_entropy
    from bacs_tpu_torch.ops.upsample_ce import upsample_plain
    from bacs_tpu_torch.ops.upsample_pseudo import plop_pseudo_labels, pseudo_labels_plain

    g = torch.Generator(device=device).manual_seed(seed)
    n, c = shape[0], shape[-1]
    sem = (torch.randn(shape, generator=g, device=device) * 2).to(dtype)
    labels = seeded_labels(n, out_hw, c + 1, device, seed)
    bg = torch.rand(labels.shape, generator=g, device=device) < 0.3
    labels = torch.where(bg & (labels != 255), torch.zeros_like(labels), labels)
    if new_image:
        labels[0] = c
    labels = labels.to(labels_dtype)
    me = torch.tensor(float(np.log(c + 1)), device=device)
    up = upsample_plain(sem, out_hw)
    ent = (pixel_entropy(torch.softmax(up, dim=-1)) / me).flatten()
    pick = torch.randint(0, ent.numel(), (2, max(c, N_CLASSES)), generator=g, device=device)
    thr = ent[pick].mean(dim=0)
    new, num, den = plop_pseudo_labels(sem, labels, thr, out_hw, me, ignore_index)
    ref, ref_num, ref_den = pseudo_labels_plain(sem, labels, thr, out_hw, me, ignore_index)
    top2 = up.topk(min(2, c), dim=-1).values
    pred = up.argmax(dim=-1)
    decisive = ((ent.reshape(pred.shape) - thr[pred]).abs() > 1e-5) & (
        (top2[..., 0] - top2[..., -1]) > 1e-5 if c > 1 else True)
    torch.cuda.synchronize()
    assert new.dtype == torch.int32 and new.shape == labels.shape
    differ = new != ref
    flips = int(differ.sum())
    assert not bool(differ[decisive].any()), "K9 differs at a decisive pixel"
    assert flips <= 1e-4 * labels.numel(), f"K9: {flips} pixels flipped"
    assert torch.equal(den, ref_den), "K9 den differs"
    assert float((num - ref_num).abs().max()) <= flips, "K9 num differs beyond the flips"
    if new_image:
        assert float(num[0]) == float(den[0]) == 0 and torch.equal(new[0], labels[0].int())
    if labels.numel() >= 4096:
        assert 0 < float(num.sum()) < float(den.sum()), "no mix of kept and ignored pixels"
    return flips


def check_confusion(shape, out_hw, dtype, device, seed=0, num_classes=None,
                    labels_dtype=torch.int32, one_bin=False) -> int:
    """K2 against its plain version; returns the pixels counted differently,
    each of which must have a top-2 margin <= 1e-4.  The labels are in [0,
    num_classes) (default: the channel count) with ~5 % 255 and ~2 % each
    -1 and num_classes, all dropped; with ``one_bin`` every label is 3 and
    class 3 leads every logit by 10, so every pixel lands in one bin."""
    from bacs_tpu_torch.ops.upsample_ce import upsample_plain
    from bacs_tpu_torch.ops.upsample_confusion import (
        confusion_plain, upsampled_confusion)

    g = torch.Generator(device=device).manual_seed(seed)
    n, c = shape[0], shape[-1]
    nc = num_classes or c
    sem = torch.randn(shape, generator=g, device=device)
    if one_bin:
        sem = sem * 0.1 + 10 * torch.nn.functional.one_hot(torch.full(shape[:-1], 3,
                                                                      device=device), c)
        labels = torch.full((n, *out_hw), 3, dtype=torch.int32, device=device)
    else:
        sem = sem * 4
        labels = seeded_labels(n, out_hw, nc, device, seed)
        drop = torch.rand(labels.shape, generator=g, device=device)
        labels = torch.where(drop < 0.02, -1, torch.where(drop > 0.98, nc, labels))
    sem, labels = sem.to(dtype), labels.to(labels_dtype)
    conf = upsampled_confusion(sem, labels, out_hw, nc)
    ref = confusion_plain(sem, labels, out_hw, nc)
    top2 = upsample_plain(sem, out_hw).topk(min(2, c), dim=-1).values
    close = int(((top2[..., 0] - top2[..., -1]) <= 1e-4).sum()) if c > 1 else 0
    torch.cuda.synchronize()
    assert conf.dtype == torch.int32 and conf.shape == (nc, nc)
    valid = int(((labels >= 0) & (labels < nc)).sum())
    assert int(conf.sum()) == valid, "pixels lost"
    if one_bin:
        assert int(conf[3, 3]) == labels.numel(), "the one bin lost pixels"
    moved = int((conf - ref).abs().sum()) // 2
    assert moved <= close, f"K2 moved {moved} pixels, {close} near ties"
    return moved


# ---------------------------------------------------------------- model


def network_cfg() -> dict:
    import yaml

    with open(NETWORK_YAML) as f:
        return yaml.safe_load(f)


def seeded_variables(cfg: dict, seed: int, use_bg_detector: bool = False,
                     smooth: bool = False):
    """Flax-layout (params, batch_stats) for the configured network (with
    the BACS background detector of N_TASKS heads if ``use_bg_detector``;
    statistics calibrated for identity activations if ``smooth``).

    Convs are drawn as the JAX package initialises them (He normal over
    fan-out; LeCun normal for the classifier), ABN scale and bias with a
    seeded spread; each bottleneck's last ABN scale is small, as in
    zero-init-residual training, which keeps the random 101-layer network
    from being chaotic (bf16 rounding would otherwise flip most argmaxes).
    The running statistics are then calibrated: one small CPU forward sets
    every ABN's mean and variance to those of its actual input, so
    activations keep a trained network's scale through 101 layers instead
    of growing without bound.  The detector's trunk norm is calibrated
    the same way; its heads are LeCun normal.
    """
    from bacs_tpu_torch.data.transforms import normalize_image
    from bacs_tpu_torch.models import create_network
    from bacs_tpu_torch.models.norm import ABN
    from bacs_tpu_torch.utils.flax_weights import state_dict_to_flax

    model = create_network(cfg["_target_"], N_CLASSES, norm=cfg["norm"],
                           backbone=cfg["backbone"], n_tasks=N_TASKS,
                           use_bg_detector=use_bg_detector).eval()
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, t in model.state_dict().items():
        if t.dim() == 4:  # conv weight [out, in, kh, kw]
            std = (2.0 / (t.shape[0] * t.shape[2] * t.shape[3])) ** 0.5
            if k.startswith("classifier_head"):
                std = (1.0 / (t.shape[1] * t.shape[2] * t.shape[3])) ** 0.5
            sd[k] = torch.randn(t.shape, generator=g) * std
        elif k.endswith("head_kernel"):  # [T, D, 1]
            sd[k] = torch.randn(t.shape, generator=g) * t.shape[1] ** -0.5
        elif k.endswith("bn3.weight"):  # damped residual branch
            sd[k] = 0.1 + 0.2 * torch.rand(t.shape, generator=g)
        elif k.endswith("weight"):  # ABN scale
            sd[k] = 0.5 + torch.rand(t.shape, generator=g)
        elif k.endswith("bias"):
            sd[k] = (torch.rand(t.shape, generator=g) - 0.5) * 0.2
        else:  # running statistics, calibrated below
            sd[k] = t.clone()
    model.load_state_dict(sd)
    if smooth:
        for m in model.modules():
            if isinstance(m, ABN):
                m.activation, m.slope = "identity", 1.0

    img = torch.randint(0, 256, (4, 128, 128, 3), generator=g, dtype=torch.uint8)
    # with the detector the full forward, so that the trunk calibrates too
    calibrate_norms(model, normalize_image(img), full=use_bg_detector)
    return state_dict_to_flax(model.state_dict())


def calibrate_norms(model, x, full=True) -> None:
    """Set every norm's running mean and variance to those of its input in
    one no-grad forward of ``x`` (``full``: ``model(x)``, else its
    ``sem_logits``)."""
    from bacs_tpu_torch.models.norm import ABN, BatchNorm

    def calibrate(m, inputs):
        y = inputs[0].float()
        m.running_mean.copy_(y.mean(dim=(0, 2, 3)))
        m.running_var.copy_(y.var(dim=(0, 2, 3), unbiased=False).clamp_min(1e-3))

    handles = [m.register_forward_pre_hook(calibrate) for m in model.modules()
               if isinstance(m, (ABN, BatchNorm))]
    with torch.no_grad():
        model(x) if full else model.sem_logits(x)
    for h in handles:
        h.remove()


def make_predictor(cfg, params, stats, dtype, device):
    from bacs_tpu_torch.serve import Predictor

    return Predictor(cfg, N_CLASSES, params, stats, crop_size=CROP,
                     dtype=dtype, device=device)


def sem_logits(predictor, images_u8: np.ndarray) -> torch.Tensor:
    from bacs_tpu_torch.data.transforms import normalize_image

    with torch.inference_mode():
        x = torch.from_numpy(images_u8).to(predictor.device)
        out = predictor.model.sem_logits(normalize_image(x).to(predictor.dtype))
    return out.float().cpu()


def abn_shapes(predictor, images_u8):
    """{NHWC shape: count} of every ABN input in one forward."""
    from bacs_tpu_torch.models.norm import ABN

    seen: dict = {}

    def hook(_m, inputs, _out):
        n, c, h, w = inputs[0].shape
        seen[(n, h, w, c)] = seen.get((n, h, w, c), 0) + 1

    handles = [m.register_forward_hook(hook) for m in predictor.model.modules()
               if isinstance(m, ABN)]
    predictor.predict(images_u8)
    for h in handles:
        h.remove()
    return seen


def profile(predictor, images_u8) -> float:
    """Kernel times of two served batches; returns device-busy ms per batch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    predictor.predict(images_u8)
    torch.cuda.synchronize()
    with sm_clock("profiled window of 2 served batches"), tprofile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            predictor.predict(images_u8)
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1000 / 2
    log("[p] profile of 2 served batches (batch 16, bf16), by device time:")
    log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=30,
                                  max_name_column_width=48))
    return busy_ms


# ---------------------------------------------------------------- training


def load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


# the network config keys create_network reads
NET_KEYS = ("norm", "backbone", "n_channels", "bilinear", "num_layers", "remat",
            "transformer")


def train_state(cfg, params, stats, dtype, device, smooth=False, fused_stem=False,
                accumulate=1, crop_size=CROP, active_classes=None, **state_kw):
    """A train state: f32 master weights from the Flax trees, convs
    computing in ``dtype``, nesterov SGD under the poly schedule, its
    gradients averaged over ``accumulate`` mini-steps.  ``cfg`` is a
    network config (DeepLabV3 or UNet, with ``remat``).  ``smooth`` gives
    every ABN (and so every block output) the identity activation in place
    of the configured leaky-ReLU; ``fused_stem`` the stem's fused ABN +
    max-pool (K12).  Flax trees with a ``seen_fg_network`` build the
    network with the background detector; ``crop_size`` and
    ``active_classes`` go to TranSeg; ``state_kw`` are further
    ``TrainState`` fields."""
    from bacs_tpu_torch.models import ABN, create_network
    from bacs_tpu_torch.train.optim import make_optimizer, make_schedule
    from bacs_tpu_torch.train.state import TrainState
    from bacs_tpu_torch.utils.flax_weights import load_flax_variables

    model = create_network(cfg["_target_"], N_CLASSES, dtype=dtype,
                           param_dtype=torch.float32, n_tasks=N_TASKS,
                           use_bg_detector="seen_fg_network" in params,
                           fused_stem=fused_stem, crop_size=crop_size,
                           active_classes=active_classes,
                           **{k: v for k, v in cfg.items() if k in NET_KEYS})
    load_flax_variables(model, params, stats)
    if smooth:
        for m in model.modules():
            if isinstance(m, ABN):
                m.activation, m.slope = "identity", 1.0
    model.to(device)
    opt_cfg = load_yaml(OPTIMIZER_YAML)
    schedule = make_schedule(load_yaml(SCHEDULER_YAML), float(opt_cfg["lr"]), MAX_ITERS)
    return TrainState(model, *make_optimizer(opt_cfg, model.parameters(), schedule,
                                             accumulate_steps=accumulate), **state_kw)


def ce_steps(device):
    from bacs_tpu_torch.methods import ModelContext, create_method
    from bacs_tpu_torch.train.state import TaskInfo
    from bacs_tpu_torch.train.step import make_steps

    task = TaskInfo(task_id=0, initial_classes=N_CLASSES, increment=0,
                    num_classes=N_CLASSES)
    return make_steps(ModelContext(task), create_method("loss.CrossEntropy"),
                      N_CLASSES, device=device)


def synthetic_batch(n, crop, gen, device, n_classes=N_CLASSES):
    """A batch whose labels are learnable from the image: a 4 x 4 grid of
    blocks per image, each of a random class in [0, n_classes) and painted
    its VOC colour, plus noise; labels within 2 px of a block edge are 255
    (about 6 %, as VOC's object boundaries).  Made on ``device`` from
    ``gen``."""
    from bacs_tpu_torch.data.transforms import normalize_image
    from bacs_tpu_torch.viz.media import voc_colormap

    k = crop // 4
    cls = torch.randint(0, n_classes, (n, 4, 4), generator=gen, device=device)
    labels = cls.repeat_interleave(k, 1).repeat_interleave(k, 2).to(torch.int32)
    palette = torch.from_numpy(voc_colormap()[:N_CLASSES]).to(device).float()
    noise = torch.randn((n, crop, crop, 3), generator=gen, device=device) * 25
    img = (palette[labels.long()] + noise).clamp(0, 255).to(torch.uint8)
    edge = torch.arange(crop, device=device) % k
    edge = (edge < 2) | (edge >= k - 2)
    labels[:, edge, :] = 255
    labels[:, :, edge] = 255
    return {"image": normalize_image(img), "label": labels.contiguous()}


def grads_and_stats(model):
    grads = {k: p.grad.detach().float().cpu() for k, p in model.named_parameters()}
    stats = {k: b.detach().float().cpu() for k, b in model.named_buffers()}
    params = {k: p.detach().float().cpu() for k, p in model.named_parameters()}
    return grads, params, stats


def max_rel_error(got: dict, ref: dict, slack: dict | None = None):
    """(max over tensors of max |got - ref| / max |ref|, its tensor's name).
    ``slack`` gives each tensor an absolute error that is not counted."""
    errs = {}
    for k in ref:
        err = float((got[k] - ref[k]).abs().max()) - (slack[k] if slack else 0.0)
        errs[k] = max(err, 0.0) / max(float(ref[k].abs().max()), 1e-30)
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def abn_joined(d: dict) -> dict:
    """``d`` with each ABN's [C] scale and bias tensors joined into one.

    In a network with identity activations, an ABN whose output reaches
    the loss only through 1 x 1 convolutions into the next ABN has a bias
    gradient of exactly 0 (the next ABN removes a constant shift); what a
    device computes there is rounding noise (~1e-9) of its sums, whose
    terms are those of the scale's gradient.  Joined, the pair is held to
    the size of those terms."""
    out = {}
    for k, v in d.items():
        stem = k.rsplit(".", 1)[0]
        scale = d.get(stem + ".weight")
        if scale is not None and scale.dim() == 1:
            out[stem] = torch.cat([scale, d[stem + ".bias"]])
        else:
            out[k] = v
    return out


def norm_error(got: dict, ref: dict) -> float:
    """||got - ref|| / ||ref|| over all tensors of two dicts."""
    diff = sum(float(((got[k] - ref[k]) ** 2).sum()) for k in ref)
    return (diff / sum(float((ref[k] ** 2).sum()) for k in ref)) ** 0.5


def hold_step(label: str, activation: str, card, cpu, p0: dict, extra: str = "") -> None:
    """Log and hold one f32 train step on the card against the same step on
    the CPU; ``card`` and ``cpu`` are (loss, grads, params, stats) and
    ``p0`` the parameters before the step.  The loss rtol 1e-5 and the
    running statistics to 1e-4 of each tensor's largest value.  With
    identity activations the network is smooth and the two devices differ
    by f32 rounding only, so every gradient (each ABN's scale and bias
    joined, ``abn_joined``) and every update beyond one ulp of its
    parameter (an f32 parameter holds its update only to that) is held to
    1e-4 of its tensor's largest value.  With the leaky ones,
    pre-activations within rounding of 0 take different sides of the kink
    on the two devices and the ABN backward spreads such a pixel over its
    channel, so gradients and updates are held to 5e-2 of their norm (the
    same effect between JAX and the port: tests/test_torch_train_step.py)."""
    (loss_g, grads_g, params_g, stats_g), (loss_c, grads_c, params_c, stats_c) = card, cpu
    upd_g = {k: params_g[k] - p0[k] for k in p0}
    upd_c = {k: params_c[k] - p0[k] for k in p0}
    grad_rel, grad_worst = max_rel_error(abn_joined(grads_g), abn_joined(grads_c))
    ulp = {k: float(torch.finfo(torch.float32).eps * v.abs().max()) for k, v in p0.items()}
    upd_rel, upd_worst = max_rel_error(upd_g, upd_c, ulp)
    stats_rel, _ = max_rel_error(stats_g, stats_c)
    grad_norm, update_norm = norm_error(grads_g, grads_c), norm_error(upd_g, upd_c)
    log(f"{label}, {activation} activations: loss {loss_g:.7f} vs {loss_c:.7f}; gradients "
        f"max rel err per tensor (each ABN's scale and bias joined) {grad_rel:.3g} "
        f"({grad_worst}), norm rel err {grad_norm:.3g}; SGD update max rel err per tensor "
        f"beyond one ulp of the parameter {upd_rel:.3g} ({upd_worst}), norm rel err "
        f"{update_norm:.3g}; running statistics max rel err {stats_rel:.3g}{extra}")
    assert np.isfinite(loss_g) and abs(loss_g - loss_c) <= 1e-5 * abs(loss_c), (loss_g, loss_c)
    assert stats_rel <= 1e-4, stats_rel
    if activation == "identity":
        assert grad_rel <= 1e-4 and upd_rel <= 1e-4, (grad_rel, upd_rel)
    else:
        assert grad_norm <= 5e-2 and update_norm <= 5e-2, (grad_norm, update_norm)


def device_kernels(fn, steps: int = 2, warm: bool = True) -> tuple:
    """The profiler's device events (kernels, copies) of ``steps`` calls of
    ``fn``, after one call unrecorded where ``warm``, and the profiler
    itself."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    if warm:
        fn()
        torch.cuda.synchronize()
    with sm_clock(f"profiled window of {steps} call(s)"):
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA], prof


def busy_ms(fn, steps: int = 2) -> float:
    """Device time of one call of ``fn``: its kernels' total, profiled."""
    events, _ = device_kernels(fn, steps)
    return sum(e.self_device_time_total for e in events) / 1000 / steps


def profile_steps(fn, label: str, steps: int = 2) -> float:
    """Device time by kernel over ``steps`` calls; returns busy ms per call."""
    events, prof = device_kernels(fn, steps)
    busy_ms = sum(e.self_device_time_total for e in events) / 1000 / steps
    log(f"[p] profile of {steps} {label}, by device time:")
    log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40,
                                  max_name_column_width=60))
    return busy_ms


def bound(bytes_moved: float, ops: float, sfu_ops: float = 0.0):
    """(ms, "bytes" or "operations"): the least time the H100 could take,
    the largest of each input read once and each output written once at
    the published 3.35 TB/s, the f32 operations at the published
    67 TFLOP/s, and the special-function operations at SFU_OPS_PER_S."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(ops / F32_OPS_PER_S, sfu_ops / SFU_OPS_PER_S)
    return 1000 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def upsample_bound(kernel: str, sem, out_hw, labels=None, extra=None):
    """The bound of an upsample kernel (K10, K1, K2, K3, K4, K6, K7, K8, K9;
    "f" forward, "b" backward) on these inputs.  The least work interpolates separably:
    a lerp (3 f32 ops) per channel along W for every source row, then along
    H for every output pixel the kernel needs: those with a valid label
    where there are labels, and for K4 only those whose label weighs
    (``extra``: the class weights).  Per such pixel and channel, K10, K1
    and K4 forward add the softmax statistics (max, subtract, exp, add: 4,
    the exp also on the SFU, with one log or reciprocal per pixel); K3
    forward adds two more sums (foreground and old-class exp-sums: 6), and
    per pixel three logarithms and the focal power (SFU 4 beyond the
    exps); a backward adds (p - target) * g (3; K3 7, its three
    normalisers) and the transposed interpolation, the same again; K2 adds
    an argmax compare (1).  Bytes: sem, the labels and ``extra`` (K3's
    max_seen, K4's weights) read, the outputs written once.

    K6 is K1 with the old classes' exp-sum (5 per channel forward, 9
    backward) and two logarithms per pixel; K8 is K1's backward with a
    per-image g.  K7 (``extra``: the teacher, C_old channels) interpolates
    both tensors at every output pixel (no labels), takes the teacher's
    softmax (4 per teacher channel), the student's with the group exp-sum
    (5 per channel) and the q_i z_i products (2 per teacher channel); the
    exponentials of both and three logarithms or reciprocals per pixel;
    its backward adds q0 s_G + q - p (5 per channel) and the transposed
    interpolation of the student.  K9 (``extra``: the thresholds) works only
    at the pixels whose label is below C: the softmax (4 per channel), the
    probability, its logarithm and the entropy's sum (4), one exponential
    and one logarithm per channel; it writes the int32 labels."""
    n, h, _, c = sem.shape
    H, W = out_hw
    sem_bytes = sem.numel() * sem.element_size()
    in_bytes = sem_bytes
    pix = n * H * W
    if labels is not None:
        in_bytes += labels.numel() * labels.element_size()
        valid = labels != 255 if kernel != "k9" else labels < c
        if kernel in ("k4f", "k4b"):
            valid &= extra[torch.where(valid, labels, 0).long()] != 0
        pix = int(valid.sum())
    if extra is not None:
        in_bytes += extra.numel() * extra.element_size()
    # at scale 1 (UNet's logits) the resize is the identity: no lerp
    lerps = 0 if tuple(sem.shape[1:3]) == (H, W) else 3 * c * (n * h * W + pix)
    sfu = pix * (c + 1)
    if kernel == "k10":  # uint8 class and f16 confidence per pixel
        return bound(in_bytes + n * H * W * 3, lerps + 4 * c * pix, sfu)
    if kernel in ("k1f", "k4f"):  # f32 sums per image
        return bound(in_bytes + 2 * n * 4, lerps + 4 * c * pix, sfu)
    if kernel in ("k1b", "k4b"):  # dsem in sem's dtype
        return bound(in_bytes + sem_bytes, 2 * lerps + 7 * c * pix, sfu)
    if kernel == "k3f":
        return bound(in_bytes + 2 * n * 4, lerps + 6 * c * pix, pix * (c + 4))
    if kernel == "k3b":
        return bound(in_bytes + sem_bytes, 2 * lerps + 13 * c * pix, pix * (c + 4))
    if kernel == "k2":  # the int32 C x C matrix
        return bound(in_bytes + c * c * 4, lerps + c * pix)
    if kernel == "k6f":
        return bound(in_bytes + 2 * n * 4, lerps + 5 * c * pix, pix * (c + 2))
    if kernel == "k6b":
        return bound(in_bytes + sem_bytes, 2 * lerps + 9 * c * pix, pix * (c + 2))
    if kernel == "k8":  # and g [n]
        return bound(in_bytes + n * 4 + sem_bytes, 2 * lerps + 7 * c * pix, sfu)
    if kernel in ("k7f", "k7b"):  # extra: the teacher
        co = extra.shape[-1]
        pix = n * H * W
        pair = 3 * (c + co) * (n * h * W + pix)
        ops, sfu = pair + (6 * co + 5 * c) * pix, pix * (c + co + 3)
        if kernel == "k7f":  # f32 sums per image
            return bound(in_bytes + 2 * n * 4, ops, sfu)
        return bound(in_bytes + sem_bytes, ops + 3 * c * (n * h * W + pix) + 5 * c * pix, sfu)
    if kernel == "k9":  # extra: the thresholds; int32 labels out
        return bound(in_bytes + n * H * W * 4 + 2 * n * 4, lerps + 8 * c * pix, pix * 2 * c)
    raise ValueError(kernel)


# ---------------------------------------------------------------- BACS

# conf/bacs/loss/bacs_plus_bg.yaml with the detector of
# conf/bacs/training/der_15_1_bg.yaml, VOC 15-1 with background: 16 classes
# at task 0, then one per task
BACS_METHOD = dict(use_bg_detector=True, bg_weighted_ce=True, alpha=0.8, beta=0.5,
                   buffer_size=300, replay_minibatch_size=12)
BACS_TASK = dict(initial_classes=16, increment=1, num_classes=N_CLASSES,
                 n_tasks=N_TASKS, max_epochs=30)
BACS_STEPS, FILL_BATCHES = 6, 20
# per BACS step: the main, alpha and beta train forwards; the previous model
TRAIN_ABN_PER_BACS_STEP = 3 * ABN_PER_FORWARD
# device kernels of a profile, by name, in the order they are matched
KERNEL_KINDS = (
    ("K12 (fused stem: ABN + leaky + max-pool, forward and backward)", ("stem_pool",)),
    ("K6 (MiB unbiased upsample+CE, forward and backward)", ("UceTerm",)),
    ("K7 (MiB unbiased KD of the upsampled pair, forward and backward)", ("UkdTerm",)),
    ("K9 (PLOP pseudo-labels)", ("PseudoTerm",)),
    ("K10 (serving upsample + argmax + confidence)", ("ArgmaxConfTerm",)),
    ("K3 (BACS upsample+CE, forward and backward)", ("BacsTerm",)),
    ("K4 (class-weighted upsample+CE)", ("WceTerm",)),
    ("K1 (upsample+CE) and K8 (its per-image backward)", ("CeTerm",)),
    ("ABN apply (K5, Triton)", ("abn_eval_kernel",)),
    ("convolutions and matrix products (cuDNN, cuBLAS)", (
        "conv", "cudnn", "xmma", "gemm", "cutlass", "wgrad", "dgrad", "fprop")),
    ("bilinear upsample (teacher distillation, detector), forward and backward",
     ("upsample_bilinear",)),
    ("SGD (foreach)", ("multi_tensor_apply",)),
)


def bacs_steps(task_id, device, **method_kw):
    """(ctx, method, (train_step, eval_step, put_batch)) of the BACS method
    at ``task_id``."""
    from bacs_tpu_torch.methods import ModelContext, create_method
    from bacs_tpu_torch.train.state import TaskInfo
    from bacs_tpu_torch.train.step import make_steps

    ctx = ModelContext(TaskInfo(task_id=task_id, **BACS_TASK))
    method = create_method("loss.BACSLoss", **{**BACS_METHOD, **method_kw})
    return ctx, method, make_steps(ctx, method, N_CLASSES, device=device)


def bacs_after_task0(cfg, seed, dev):
    """[14]'s set-up at 512^2 in bf16: the BACS state with the detector and
    the prototypes at task 0, then its ``end_task`` over FILL_BATCHES
    synthetic batches of 16 (the sweep, the snapshot and the 300-slot
    buffer's fill); returns (state, method, seconds of ``end_task``, the
    batches' generator)."""
    params_d, stats_d = seeded_variables(cfg, seed, use_bg_detector=True)
    dim = len(params_d["seen_fg_network"]["base_bn"]["scale"])  # the trunk's width
    state = train_state(cfg, params_d, stats_d, torch.bfloat16, dev,
                        generator=torch.Generator(dev).manual_seed(seed),
                        prototypes=torch.zeros((N_TASKS, dim), device=dev),
                        proto_counts=torch.zeros(N_TASKS, device=dev))
    ctx0, method, _ = bacs_steps(0, dev)
    state.buffer = method.init_buffer(ctx0.task, (CROP, CROP), (CROP // 16, CROP // 16),
                                      device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    fill = [synthetic_batch(BATCH, CROP, gen, dev, n_classes=16)
            for _ in range(FILL_BATCHES)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = method.end_task(state, ctx0, fill)
    torch.cuda.synchronize()
    return state, method, time.perf_counter() - t0, gen


def bacs_busy_main(args) -> int:
    """``--bacs-busy``: build, then [14]'s set-up and two warm-up task-1
    BACS steps, and print the step's device busy ms (the profiler's device
    time of two steps on one batch, per step, three times) as one JSON line
    (with ``--package-root`` the port of another checkout, so that the
    parent and the change are timed in one call)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))
    from bacs_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    build.load_library()
    state, _, _, gen = bacs_after_task0(network_cfg(), args.seed, dev)
    _, _, (bacs_train, _, _) = bacs_steps(1, dev)
    for _ in range(WARMUP_STEPS):
        state, _ = bacs_train(state, synthetic_batch(BATCH, CROP, gen, dev, 17))
    batch = synthetic_batch(BATCH, CROP, gen, dev, 17)
    busy = [busy_ms(lambda: bacs_train(state, batch)) for _ in range(3)]
    print(json.dumps({"bacs_busy_ms": busy, "package": os.path.dirname(build.PKG_DIR),
                      "smi": nvidia_smi(),
                      "sm_clock": nvidia_smi("clocks.sm,clocks.max.sm")}), flush=True)
    return 0


@contextlib.contextmanager
def injected_draws(keys, crop_params):
    """The BACS step's random draws fixed, whatever the device: the two
    buffer samples take the Gumbel ``keys`` in turn, the replay crop and
    flip take ``crop_params``, the autocontrast does not apply (its
    stretched images make the stem's batch variance cancel, which amplifies
    rounding: tests/test_torch_bacs_step.py)."""
    import bacs_tpu_torch.methods.bacs as bacs_mod
    from bacs_tpu_torch.data.transforms import apply_crop_params

    saved = (bacs_mod.buffer_lib.sample, bacs_mod.random_autocontrast,
             bacs_mod.replay_augment)
    sample, autocontrast, _ = saved
    turn = itertools.cycle(keys)
    bacs_mod.buffer_lib.sample = lambda buf, n, gen=None: sample(buf, n, keys=next(turn))
    bacs_mod.random_autocontrast = lambda x, gen=None, p=0.5: autocontrast(x, gen, 0.0)
    bacs_mod.replay_augment = lambda im, lab, gen=None: apply_crop_params(
        im, lab, {k: v.to(im.device) for k, v in crop_params.items()})
    try:
        yield
    finally:
        (bacs_mod.buffer_lib.sample, bacs_mod.random_autocontrast,
         bacs_mod.replay_augment) = saved


def bacs_step_card_vs_cpu(cfg, seed, dev):
    """[13] One f32 BACS step at task 1, RN101 4 x 128^2 (replay 4 from 8
    slots), on the card and on the CPU (TF32 off), with identity and with
    the configured leaky activations; the draws injected and the
    detector's dropout off.  Holds the loss, every gradient and update
    tensor (each norm's scale and bias joined), the running statistics and
    the prototypes, as phase [8]."""
    from bacs_tpu_torch.train import buffer as buffer_lib
    from bacs_tpu_torch.train.state import TaskInfo, frozen_copy

    crop, n, replay, slots = 128, 4, 4, 8
    # statistics calibrated for each network's own activations, so the
    # previous model's eval-mode embeddings keep the train-mode scale
    variables = {a: seeded_variables(cfg, seed, use_bg_detector=True,
                                     smooth=a == "identity")
                 for a in ("identity", "leaky")}
    params = variables["leaky"][0]
    gen = torch.Generator().manual_seed(seed)
    batch = synthetic_batch(n, crop, gen, "cpu", n_classes=17)
    fill = synthetic_batch(slots + 2, crop, gen, "cpu", n_classes=16)
    _, method, _ = bacs_steps(1, "cpu", buffer_size=slots, replay_minibatch_size=replay)
    buf = method.init_buffer(TaskInfo(task_id=0, **BACS_TASK), (crop, crop),
                             (crop // 16, crop // 16), device="cpu")
    buffer_lib.add_batch(buf, fill["image"],
                         torch.randn((slots + 2, crop // 16, crop // 16, N_CLASSES),
                                     generator=gen),
                         fill["label"], -torch.rand(slots + 2, generator=gen), task_id=0,
                         n_classes=16, generator=gen)
    dim = len(params["seen_fg_network"]["base_bn"]["scale"])  # the trunk's width
    protos = torch.rand((N_TASKS, dim), generator=gen)
    counts = torch.tensor([50.0] + [0.0] * (N_TASKS - 1))
    keys = [-torch.log(-torch.log(torch.rand(slots, generator=gen))) for _ in range(2)]
    crop_params = dict(i=torch.tensor([3.5, 0.0, 40.25, 0.0]),
                       j=torch.tensor([0.0, 17.0, 2.5, 0.0]),
                       ch=torch.tensor([80.0, 128.0, 61.0, 128.0]),
                       cw=torch.tensor([105.0, 66.0, 120.0, 128.0]),
                       flip=torch.tensor([True, False, False, True]))
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    trunk = [k for k in params["seen_fg_network"] if k.startswith("base_")]
    for activation, (params, stats) in variables.items():
        runs = []
        for device in (dev, torch.device("cpu")):
            state = train_state(
                cfg, params, stats, torch.float32, device, smooth=activation == "identity",
                generator=torch.Generator(device).manual_seed(seed),
                prototypes=protos.to(device), proto_counts=counts.to(device),
                buffer=buf.to(device))
            state.model.seen_fg_network.dropout_rate = 0.0
            state.prev_model = frozen_copy(state.model)
            p0 = {k: p.detach().cpu().clone() for k, p in state.model.named_parameters()}
            _, _, (train_step, _, put_batch) = bacs_steps(
                1, device, buffer_size=slots, replay_minibatch_size=replay)
            with injected_draws([k.to(device) for k in keys], crop_params):
                state, metrics = train_step(state, put_batch(batch))
            runs.append((float(metrics["loss"]), *grads_and_stats(state.model),
                         state.prototypes.cpu(), state.proto_counts.cpu()))
            del state
        (loss_g, grads_g, params_g, stats_g, protos_g, counts_g), (
            loss_c, grads_c, params_c, stats_c, protos_c, counts_c) = runs
        for k in trunk:  # no gradient reaches the detector trunk at task 1
            for grads in (grads_g, grads_c):
                assert not any(bool(v.any()) for key, v in grads.items()
                               if key.startswith(f"seen_fg_network.{k}")), k
        proto_rel = float((protos_g - protos_c).abs().max() / protos_c.abs().max())
        hold_step(f"[13] f32 BACS step card vs CPU, RN101 {n} x {crop}^2, task 1, replay "
                  f"{replay}", activation, (loss_g, grads_g, params_g, stats_g),
                  (loss_c, grads_c, params_c, stats_c), p0,
                  f"; prototypes {proto_rel:.3g}, counts {counts_g.tolist()}")
        assert proto_rel <= 1e-4 and torch.equal(counts_g, counts_c), proto_rel
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def profile_by_kind(fn, label: str, steps: int = 2):
    """Device time of ``steps`` calls by kernel (the table) and by kind
    (``KERNEL_KINDS``, the rest summed as "other"); returns (busy ms per
    call, {kind: ms per call})."""
    events, prof = device_kernels(fn, steps)
    parts: dict = {}
    for e in events:
        part = next((p for p, keys in KERNEL_KINDS
                     if any(k in e.key for k in keys)),
                    "other (elementwise, reductions, copies: train-ABN statistics and "
                    "backward, residual adds, losses)")
        parts[part] = parts.get(part, 0.0) + e.self_device_time_total / 1000 / steps
    log(f"[p] profile of {steps} {label}, by device time:")
    log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40,
                                  max_name_column_width=60))
    return sum(parts.values()), parts


def bacs_step_parts(state, ctx, method, batch, att, seen, timer=busy_ms) -> dict:
    """{part: ms} of a task-1 BACS step's parts, each run alone at the
    step's shapes and timed by ``timer``: the three network forwards and
    backwards, the previous model's forward, the teacher distillation (on
    the embeddings ``att`` and seen-probabilities ``seen``), the seen
    detector and the SGD update.  Moves the state's parameters."""
    from bacs_tpu_torch.ops.losses import binary_focal_loss
    from bacs_tpu_torch.train.optim import apply_updates

    model, image, labels = state.model, batch["image"], batch["label"]
    n_replay = method.replay_minibatch_size

    def network(images):
        def run():
            state.optimizer.zero_grad(set_to_none=True)
            out = ctx.forward(model, images, True, state.generator)
            out.sem_logits.float().square().mean().backward()
        return run

    with torch.no_grad():
        pen = ctx.forward(model, image, True, state.generator).penultimate

    def detector():
        with torch.no_grad():
            model.seen_probs(pen, state.prototypes, ctx.task.task_id + 1)
        seen_logits = model.seen_map_task(pen, state.prototypes, ctx.task.task_id,
                                          stop_grads=True)
        binary_focal_loss(seen_logits[..., 0], (labels != 0).long(),
                          gamma=method.seen_gamma).backward()

    return {
        f"main batch: network forward + backward ({image.shape[0]} images, train mode)":
            timer(network(image)),
        f"alpha and beta replay: network forward + backward (2 x {n_replay} images)":
            2 * timer(network(image[:n_replay].contiguous())),
        f"previous model: eval forward ({image.shape[0]} images, K5)":
            timer(lambda: ctx.forward_prev(state, image)),
        "teacher distillation, forward + backward":
            timer(lambda: method._teacher_distill(att[0], att[1], seen, labels).backward()),
        "seen detector: probabilities, map, focal loss, backward": timer(detector),
        "SGD update (zero-fill, clip, foreach SGD)":
            timer(lambda: apply_updates(state.optimizer, state.scheduler)),
    }


# ---------------------------------------------------------------- MiB and PLOP

# conf/experiments/{mib,plop}_config.yaml with training/cont_15_1.yaml: VOC
# 15-1 (16 classes with background at task 0, then one per task), batch 12
MIB_PLOP_METHODS = ("loss.MiB", "loss.PlopLoss")
MIB_PLOP_BATCH, MIB_PLOP_STEPS, PLOP_BEGIN_BATCHES = 12, 6, 10
OLD_CLASSES = 16
MIB_PLOP_CASES = [((12, 32, 32, 17), (512, 512)), ((2, 33, 47, 17), (261, 373)),
                  ((2, 5, 7, 6), (37, 51))]


def method_steps(name, task_id, device):
    """(ctx, method, (train_step, eval_step, put_batch)) of a method on the
    VOC 15-1 tasks at ``task_id``."""
    from bacs_tpu_torch.methods import ModelContext, create_method
    from bacs_tpu_torch.train.state import TaskInfo
    from bacs_tpu_torch.train.step import make_steps

    ctx = ModelContext(TaskInfo(task_id=task_id, **BACS_TASK))
    method = create_method(name)
    return ctx, method, make_steps(ctx, method, N_CLASSES, device=device)


def mib_plop_kernel_checks(dev) -> dict:
    """[16] K6 and K7, [17] K8 and K9 against their plain versions at the
    MiB and PLOP steps' shapes and odd ones, f32 and bf16; returns the
    largest absolute errors (K9: pixels flipped)."""
    errs = dict(k6f=0.0, k6b=0.0, k7f=0.0, k7b=0.0, k8=0.0, k9=0)
    for shape, out_hw in MIB_PLOP_CASES:
        for dt in (torch.float32, torch.bfloat16):
            e = check_uce(shape, out_hw, dt, dev)
            errs["k6f"], errs["k6b"] = max(errs["k6f"], e["val_abs"]), max(errs["k6b"],
                                                                          e["grad_abs"])
            log(f"[16] K6 {shape}->{out_hw} {str(dt)[6:]}, old classes {shape[-1] - 1}: ok, "
                f"sum max abs err {e['val_abs']:.3g} (rel {e['val_rel']:.3g}), gradient "
                f"max abs err {e['grad_abs']:.3g} (rel {e['grad_rel']:.3g})")
            for alpha in (1.0, 0.7):
                e = check_ukd(shape, out_hw, dt, dev, alpha=alpha)
                errs["k7f"] = max(errs["k7f"], e["val_abs"])
                errs["k7b"] = max(errs["k7b"], e["grad_abs"])
                log(f"[16] K7 {shape}->{out_hw} {str(dt)[6:]}, teacher {shape[-1] - 1} "
                    f"channels, alpha {alpha}: ok, sum max abs err {e['val_abs']:.3g} (rel "
                    f"{e['val_rel']:.3g}), gradient max abs err {e['grad_abs']:.3g} (rel "
                    f"{e['grad_rel']:.3g})")
    for shape, out_hw in MIB_PLOP_CASES:
        for dt in (torch.float32, torch.bfloat16):
            e = check_ce_per_image(shape, out_hw, dt, dev)
            errs["k8"] = max(errs["k8"], e["grad_abs"])
            teacher = (*shape[:3], shape[-1] - 1)
            flips = check_pseudo(teacher, out_hw, dt, dev)
            errs["k9"] = max(errs["k9"], flips)
            log(f"[17] K8 {shape}->{out_hw} {str(dt)[6:]}: ok, gradient max abs err "
                f"{e['grad_abs']:.3g} (rel {e['grad_rel']:.3g}), K1's scalar case bit for "
                f"bit; K9 {teacher}: ok, {flips} pixels flipped (all within 1e-5 of a "
                "threshold or a tie)")
    for c in CHUNK_CHANNELS:
        errs["k9"] = max(errs["k9"], check_pseudo((2, 8, 8, c), (128, 128), torch.bfloat16,
                                                  dev))
    errs["k9"] = max(errs["k9"], check_pseudo(
        (2, 5, 7, 16), (37, 51), torch.float32, dev, labels_dtype=torch.int64,
        ignore_index=-100, new_image=True))
    log(f"[17] K9 at {CHUNK_CHANNELS} channels, and with int64 labels, ignore index -100 "
        "and an image of new-class labels only: ok")
    return errs


def plop_thresholds_with_margin(state, ctx, batch):
    """PLOP thresholds [N_CLASSES] f32 (CPU) for ``batch`` that no pixel of
    the step's mask lies within 1e-5 of: from the previous model's
    entropies, each class's in the widest gap of its pixels' values (else
    just above them all).  A pixel whose top two teacher logits are within
    1e-4 (where the devices' rounding could pick another class) is labelled
    255 in ``batch`` first, in place.  So the two devices label alike."""
    from bacs_tpu_torch.ops.losses import pixel_entropy
    from bacs_tpu_torch.ops.upsample_ce import upsample_plain

    old = ctx.task.old_classes
    with torch.no_grad():
        sem = ctx.forward_prev(state, batch["image"]).sem_logits[..., :old]
    up = upsample_plain(sem, tuple(batch["label"].shape[1:3])).double()
    ent = pixel_entropy(torch.softmax(up, dim=-1)) / np.log(ctx.n_cur)
    pred = up.argmax(dim=-1)
    top2 = up.topk(2, dim=-1).values
    batch["label"][(top2[..., 0] - top2[..., 1]) <= 1e-4] = 255
    mask = batch["label"] < old
    thr = torch.zeros(N_CLASSES)
    for c in range(old):
        vals = torch.unique(ent[mask & (pred == c)])  # sorted
        gaps = vals.diff()
        if len(gaps) and float(gaps.max()) > 1e-4:
            i = int(gaps.argmax())
            thr[c] = float(vals[i] + vals[i + 1]) / 2
        else:
            thr[c] = (float(vals[-1]) if len(vals) else 0.0) + 1e-3
    assert float((ent - thr.double()[pred]).abs()[mask].min()) > 1e-5
    return thr


def mib_plop_step_card_vs_cpu(cfg, seed, dev):
    """[18] One f32 task-1 step of MiB and of PLOP after the imprinting,
    RN101 4 x 128^2, on the CPU and on the card (TF32 off), with identity
    and with the configured leaky activations; PLOP's thresholds set with
    a margin from the CPU's teacher (``plop_thresholds_with_margin``).
    Held as phase [13] holds the BACS step."""
    from bacs_tpu_torch.train.learner import multihead_init
    from bacs_tpu_torch.train.state import frozen_copy

    crop, n = 128, 4
    variables = {a: seeded_variables(cfg, seed, smooth=a == "identity")
                 for a in ("identity", "leaky")}
    batch = synthetic_batch(n, crop, torch.Generator().manual_seed(seed), "cpu",
                            n_classes=OLD_CLASSES + 1)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in MIB_PLOP_METHODS:
        for activation, (params, stats) in variables.items():
            runs, thresholds = [], None
            for device in (torch.device("cpu"), dev):
                ctx, _, (train_step, _, put_batch) = method_steps(name, 1, device)
                state = train_state(cfg, params, stats, torch.float32, device,
                                    smooth=activation == "identity")
                state.prev_model = frozen_copy(state.model)
                multihead_init(state, ctx.task)
                if name == "loss.PlopLoss":
                    if thresholds is None:
                        thresholds = plop_thresholds_with_margin(state, ctx, batch)
                    state.plop_thresholds = thresholds.to(device)
                    state.plop_max_entropy = torch.tensor(float(np.log(ctx.n_cur)),
                                                          device=device)
                p0 = {k: p.detach().cpu().clone() for k, p in state.model.named_parameters()}
                state, metrics = train_step(state, put_batch(batch))
                runs.append((float(metrics["loss"]), *grads_and_stats(state.model)))
                del state
            hold_step(f"[18] f32 {name} step card vs CPU, RN101 {n} x {crop}^2, task 1",
                      activation, runs[1], runs[0], p0)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def mib_plop_steps_512(cfg, params, stats, seed, dev, reset_counts, counts) -> dict:
    """[19] per method at 512^2 in bf16, batch 12: ``end_task`` of task 0
    (the previous-model snapshot), the imprinting of the new class, for
    PLOP ``begin_task`` over PLOP_BEGIN_BATCHES synthetic batches (timed),
    then 2 warm-up and MIB_PLOP_STEPS timed task-1 steps with the counters
    reset just before, the launches asserted per step, a finite loss, and a
    two-step profile by kernel; [20] its task-1 eval steps.  Returns, per
    method, the launch counts of the timed steps and of the eval steps."""
    from bacs_tpu_torch.train.learner import multihead_init

    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    n_cls = OLD_CLASSES + 1
    results = {}
    for name in MIB_PLOP_METHODS:
        state = train_state(cfg, params, stats, torch.bfloat16, dev,
                            generator=torch.Generator(dev).manual_seed(seed))
        ctx0, method, _ = method_steps(name, 0, dev)
        state = method.end_task(state, ctx0, [])
        ctx1, _, (train_step, eval_step, _) = method_steps(name, 1, dev)
        multihead_init(state, ctx1.task)
        if name == "loss.PlopLoss":
            begin = [synthetic_batch(MIB_PLOP_BATCH, CROP, gen, dev, n_cls)
                     for _ in range(PLOP_BEGIN_BATCHES)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = method.begin_task(state, ctx1, begin)
            t_begin = time.perf_counter() - t0
            thr = state.plop_thresholds.cpu()
            log(f"[19] PLOP begin_task of task 1 over {PLOP_BEGIN_BATCHES} batches of "
                f"{MIB_PLOP_BATCH} at {CROP}^2: {t_begin:.3f} s; thresholds of the "
                f"{ctx1.n_cur} classes {[round(float(v), 5) for v in thr[:ctx1.n_cur]]}, "
                f"max entropy {float(state.plop_max_entropy):.5f}")
            assert bool(torch.isfinite(thr).all()) and bool((thr[:ctx1.n_cur] >= 0.001).all())
            del begin
        losses = []
        for _ in range(WARMUP_STEPS):
            state, metrics = train_step(state, synthetic_batch(MIB_PLOP_BATCH, CROP, gen, dev,
                                                               n_cls))
            losses.append(float(metrics["loss"]))
        batches = [synthetic_batch(MIB_PLOP_BATCH, CROP, gen, dev, n_cls)
                   for _ in range(MIB_PLOP_STEPS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        step_ms = []
        for b in batches:
            t0 = time.perf_counter()
            state, metrics = train_step(state, b)
            losses.append(float(metrics["loss"]))  # a host read: synchronises
            step_ms.append(1000 * (time.perf_counter() - t0))
        got = counts()
        peak = torch.cuda.max_memory_allocated()
        med = float(np.median(step_ms))
        log(f"[19] bf16 {name} step (task 1), batch {MIB_PLOP_BATCH}, {CROP}^2: median "
            f"{med:.3f} ms ({MIB_PLOP_BATCH * 1000 / med:.2f} img/s; min {min(step_ms):.3f}, "
            f"max {max(step_ms):.3f} ms over {MIB_PLOP_STEPS} steps); peak memory "
            f"{peak / 2**30:.3f} GiB; launches {got} over {MIB_PLOP_STEPS} steps")
        log(f"[19] {name} loss: {' '.join(f'{v:.4f}' for v in losses)}")
        assert all(np.isfinite(losses)), losses
        per_step = {k: v / MIB_PLOP_STEPS for k, v in got.items()}
        assert per_step["train_abn"] == per_step["k5"] == ABN_PER_FORWARD, per_step
        if name == "loss.MiB":
            ran, idle = ("k6f", "k6b", "k7f", "k7b"), ("k1f", "k1b", "k8", "k9")
        else:  # K1's forward per image, K8 its backward
            ran, idle = ("k9", "k1f", "k8"), ("k1b", "k6f", "k6b", "k7f", "k7b")
        assert all(per_step[k] == 1 for k in ran), per_step
        assert all(got[k] == 0 for k in idle + ("k2", "k3f", "k3b", "k4f", "k4b", "k10")), got
        busy, parts = profile_by_kind(lambda: train_step(state, batches[0]),
                                      f"bf16 {name} steps (batch {MIB_PLOP_BATCH}, {CROP}^2)")
        for part, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
            log(f"[p] {name} step by kernel kind: {ms:.3f} ms ({ms / busy:.1%}) {part}")
        earlier = EARLIER_BUSY_MS[f"{'MiB' if name.endswith('MiB') else 'PLOP'} step (phase [19])"]
        log(f"[p] {name}: device busy {busy:.3f} ms per step (before: {earlier}); median step "
            f"wall {med:.3f} "
            f"ms: device idle share {1 - busy / med:.3f}")

        conf_mat = torch.zeros((N_CLASSES, N_CLASSES), dtype=torch.int32, device=dev)
        eval_step(state, conf_mat.clone(), batches[0])  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        for b in batches[:EVAL_STEPS]:
            conf_mat, loss = eval_step(state, conf_mat, b)
            assert np.isfinite(float(loss))
        ev = counts()
        valid = sum(int((b["label"] != 255).sum()) for b in batches[:EVAL_STEPS])
        log(f"[20] bf16 {name} eval step at task 1, batch {MIB_PLOP_BATCH}: launches {ev} "
            f"over {EVAL_STEPS} steps; confusion counts {int(conf_mat.sum())} of {valid} "
            f"valid pixels")
        assert int(conf_mat.sum()) == valid
        assert ev["k5"] == ABN_PER_FORWARD * EVAL_STEPS
        assert ev["k1f"] == ev["k2"] == EVAL_STEPS
        assert sum(v for k, v in ev.items() if k not in ("k5", "k1f", "k2")) == 0, ev
        results[name] = dict(steps=got, eval=ev)
        del state, batches
        torch.cuda.empty_cache()
    return results


def mib_plop_kernel_times(dev, seed) -> tuple:
    """[t] K6-K9 at the MiB and PLOP steps' shapes (student bf16 [12, 32, 32,
    17], teacher [12, 32, 32, 16], 512^2, synthetic labels of 17 classes)
    beside their plain versions (timed host-launched by CUDA events, as
    K1-K4's), and their bounds; returns ({key: (ms, plain ms)}, {key:
    bound}).  K9 and K8 take the entropy thresholds that PLOP's
    ``begin_task`` sets on this teacher and these labels (each class's
    histogram median), so K8's labels keep the share of pixels a step's
    would."""
    from bacs_tpu_torch.methods.plop import NB_BINS, add_entropy_histogram, entropy_thresholds
    from bacs_tpu_torch.ops.upsample_ce import (
        ce_dsem_per_image, ce_dsem_per_image_plain, uce_dsem, uce_dsem_plain, uce_sums,
        uce_sums_plain, ukd_dsem, ukd_dsem_plain, ukd_sum, ukd_sum_plain, upsample_plain)
    from bacs_tpu_torch.ops.upsample_pseudo import plop_pseudo_labels, pseudo_labels_plain

    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    hw = (CROP, CROP)
    lab = synthetic_batch(MIB_PLOP_BATCH, CROP, gen, dev, OLD_CLASSES + 1)["label"]
    h = CROP // 16
    sem = (torch.randn((MIB_PLOP_BATCH, h, h, OLD_CLASSES + 1), generator=gen, device=dev)
           * 3).to(torch.bfloat16)
    old = (torch.randn((MIB_PLOP_BATCH, h, h, OLD_CLASSES), generator=gen, device=dev)
           * 3).to(torch.bfloat16)
    g = torch.tensor(1.0 / lab.numel(), device=dev)
    g_kd = -g
    hist = torch.zeros((OLD_CLASSES + 1, NB_BINS), dtype=torch.int64, device=dev)
    add_entropy_histogram(hist, upsample_plain(old, hw), lab)
    thr = entropy_thresholds(hist, N_CLASSES).to(dev)
    me = torch.tensor(float(np.log(OLD_CLASSES + 1)), device=dev)
    pseudo, num, den = plop_pseudo_labels(old, lab, thr, hw, me)
    log(f"[t] K8/K9 labels: begin_task's thresholds on this teacher "
        f"{[round(v, 5) for v in thr[:OLD_CLASSES + 1].tolist()]}; "
        f"{float(num.sum() / den.sum()):.4f} of the {int(den.sum())} background and "
        f"old-class pixels keep a pseudo-label; {float((pseudo != 255).float().mean()):.4f} "
        f"of all pixels have a valid label (the input had "
        f"{float((lab != 255).float().mean()):.4f})")
    gvec = (num / den.clamp(min=1) / lab.numel()).contiguous()
    times = {
        "k6f": (device_ms(lambda: uce_sums(sem, lab, hw, OLD_CLASSES)),
                time_ms(lambda: uce_sums_plain(sem, lab, hw, OLD_CLASSES), iters=5)),
        "k6b": (device_ms(lambda: uce_dsem(sem, lab, hw, g, OLD_CLASSES)),
                time_ms(lambda: uce_dsem_plain(sem, lab, hw, g, OLD_CLASSES), iters=3)),
        "k7f": (device_ms(lambda: ukd_sum(sem, old, hw)),
                time_ms(lambda: ukd_sum_plain(sem, old, hw), iters=5)),
        "k7b": (device_ms(lambda: ukd_dsem(sem, old, hw, g_kd)),
                time_ms(lambda: ukd_dsem_plain(sem, old, hw, g_kd), iters=3)),
        "k8": (device_ms(lambda: ce_dsem_per_image(sem, pseudo, hw, gvec)),
               time_ms(lambda: ce_dsem_per_image_plain(sem, pseudo, hw, gvec), iters=5)),
        "k9": (device_ms(lambda: plop_pseudo_labels(old, lab, thr, hw, me)),
               time_ms(lambda: pseudo_labels_plain(old, lab, thr, hw, me), iters=5)),
    }
    bounds = {k: upsample_bound(k, sem, hw, lab) for k in ("k6f", "k6b")}
    bounds.update({k: upsample_bound(k, sem, hw, extra=old) for k in ("k7f", "k7b")})
    bounds["k8"] = upsample_bound("k8", sem, hw, pseudo)
    bounds["k9"] = upsample_bound("k9", old, hw, lab, thr)
    for key, label in (("k6f", "K6 forward"), ("k6b", "K6 backward"), ("k7f", "K7 forward"),
                       ("k7b", "K7 backward"), ("k8", "K8"), ("k9", "K9")):
        shape = tuple((old if key == "k9" else sem).shape)
        log(f"[t] {label} {shape}->{CROP}^2 bf16, int32 labels: kernel {times[key][0]:.4f} "
            "ms" + (f" (before: {EARLIER_KERNEL_MS[key]})" if key in EARLIER_KERNEL_MS else "")
            + f", plain {times[key][1]:.4f} ms, bound {bounds[key][0]:.4f} ms "
            f"({bounds[key][1]})")
    return times, bounds


# ---------------------------------------------------------------- ER, SDR and iCaRL

# conf/experiments/loss/{er,sdr,icarl}.yaml with training/cont_15_1.yaml: VOC
# 15-1, batch 12; ER keeps 50 slots a task and replays 12
MORE_METHODS = {"loss.ExperienceReplay": dict(buffer_size=50, replay_minibatch_size=12),
                "loss.SDR": {}, "loss.IcarlLoss": {}}
MORE_STEPS, ER_FILL_BATCHES = 4, 6
# the launches per task-1 train step the code implies, written before the
# first run: ER the main CE (K1 each way) and the replay's class-weighted CE
# (K4 each way) over two train forwards, no previous model; SDR the unbiased
# CE (K6) and KD (K7) each way, one train forward and the previous model
# (K5); iCaRL its BCE and CE on the full-resolution logits, no upsample
# kernel.  Every other counter stays 0.
MORE_STEP_LAUNCHES = {
    "loss.ExperienceReplay": dict(k1f=1, k1b=1, k4f=1, k4b=1, train_abn=2 * ABN_PER_FORWARD),
    "loss.SDR": dict(k6f=1, k6b=1, k7f=1, k7b=1, train_abn=ABN_PER_FORWARD,
                     k5=ABN_PER_FORWARD),
    "loss.IcarlLoss": dict(train_abn=ABN_PER_FORWARD, k5=ABN_PER_FORWARD),
}
# per task-1 eval step: the eval forward (K5) and the confusion (K2), the
# loss K1's forward (ER), K6's (SDR) or composed (iCaRL)
MORE_EVAL_LAUNCHES = {
    "loss.ExperienceReplay": dict(k5=ABN_PER_FORWARD, k1f=1, k2=1),
    "loss.SDR": dict(k5=ABN_PER_FORWARD, k6f=1, k2=1),
    "loss.IcarlLoss": dict(k5=ABN_PER_FORWARD, k2=1),
}


def more_steps(name, task_id, device, **method_kw):
    """(ctx, method, (train_step, eval_step, put_batch)) of ER, SDR or iCaRL
    on the VOC 15-1 tasks at ``task_id``."""
    from bacs_tpu_torch.methods import ModelContext, create_method
    from bacs_tpu_torch.train.state import TaskInfo
    from bacs_tpu_torch.train.step import make_steps

    ctx = ModelContext(TaskInfo(task_id=task_id, **BACS_TASK))
    method = create_method(name, **{**MORE_METHODS[name], **method_kw})
    return ctx, method, make_steps(ctx, method, N_CLASSES, device=device)


@contextlib.contextmanager
def injected_er_draws(keys, crop_params):
    """ER's replay draws fixed, whatever the device: the buffer sample takes
    the Gumbel ``keys`` (within the replayed task's slots), the replay crop
    and flip take ``crop_params``."""
    import bacs_tpu_torch.methods.er as er_mod
    from bacs_tpu_torch.data.transforms import apply_crop_params

    saved = (er_mod.buffer_lib.sample, er_mod.replay_augment)
    sample = saved[0]
    er_mod.buffer_lib.sample = lambda buf, n, gen=None, task_id=None: sample(
        buf, n, keys=keys.to(buf.valid.device), task_id=task_id)
    er_mod.replay_augment = lambda im, lab, gen=None: apply_crop_params(
        im, lab, {k: v.to(im.device) for k, v in crop_params.items()})
    try:
        yield
    finally:
        er_mod.buffer_lib.sample, er_mod.replay_augment = saved


def more_state(cfg, params, stats, dtype, device, name, ctx0, method, smooth=False,
               seed=0, image_hw=(CROP, CROP)):
    """A task-0 state of ER, SDR or iCaRL: ER's buffer, SDR's class
    prototypes (zero) on ``device``."""
    state = train_state(cfg, params, stats, dtype, device, smooth=smooth,
                        generator=torch.Generator(device).manual_seed(seed))
    if name == "loss.ExperienceReplay":
        state.buffer = method.init_buffer(ctx0.task, image_hw,
                                          tuple(d // 16 for d in image_hw), device=device)
    if name == "loss.SDR":
        with torch.no_grad():
            dim = state.model.eval()(torch.zeros((1, 32, 32, 3), device=device)
                                     ).penultimate.shape[-1]
        state.class_prototypes = torch.zeros((N_CLASSES, dim), device=device)
        state.class_proto_counts = torch.zeros(N_CLASSES, device=device)
    return state


def more_step_card_vs_cpu(cfg, seed, dev):
    """[25] One f32 task-1 step of ER, SDR and iCaRL, RN101 4 x 128^2, on the
    CPU and on the card (TF32 off), with identity and with the configured
    leaky activations: task 0's ``end_task`` over three batches (ER's
    buffer, 8 slots a task, takes the first two, no reservoir draw; SDR
    and iCaRL snapshot the previous model), the imprinting, then the step,
    ER's replay draws injected (``injected_er_draws``, replay 4).  Held as
    phase [13] holds the BACS step, with SDR's class prototypes and ER's
    buffer importances."""
    from bacs_tpu_torch.train.learner import multihead_init

    crop, n, slots, replay = 128, 4, 8, 4
    variables = {a: seeded_variables(cfg, seed, smooth=a == "identity")
                 for a in ("identity", "leaky")}
    gen = torch.Generator().manual_seed(seed)
    batch = synthetic_batch(n, crop, gen, "cpu", n_classes=OLD_CLASSES + 1)
    fill = [synthetic_batch(n, crop, gen, "cpu", n_classes=OLD_CLASSES) for _ in range(3)]
    keys = -torch.log(-torch.log(torch.rand(slots * N_TASKS, generator=gen)))
    crop_params = dict(i=torch.tensor([3.5, 0.0, 40.25, 0.0]),
                       j=torch.tensor([0.0, 17.0, 2.5, 0.0]),
                       ch=torch.tensor([80.0, 128.0, 61.0, 128.0]),
                       cw=torch.tensor([105.0, 66.0, 120.0, 128.0]),
                       flip=torch.tensor([True, False, False, True]))
    er_kw = dict(buffer_size=slots, replay_minibatch_size=replay)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in MORE_METHODS:
        kw = er_kw if name == "loss.ExperienceReplay" else {}
        for activation, (params, stats) in variables.items():
            runs, extras = [], []
            for device in (torch.device("cpu"), dev):
                ctx0, method, _ = more_steps(name, 0, device, **kw)
                state = more_state(cfg, params, stats, torch.float32, device, name, ctx0,
                                   method, smooth=activation == "identity", seed=seed,
                                   image_hw=(crop, crop))
                state = method.end_task(state, ctx0, [
                    {k: v.to(device) for k, v in b.items()} for b in fill])
                ctx1, _, (train_step, _, put_batch) = more_steps(name, 1, device, **kw)
                multihead_init(state, ctx1.task)
                p0 = {k: p.detach().cpu().clone() for k, p in state.model.named_parameters()}
                with injected_er_draws(keys, crop_params):
                    state, metrics = train_step(state, put_batch(batch))
                runs.append((float(metrics["loss"]), *grads_and_stats(state.model)))
                extras.append(state.buffer.importance.cpu() if state.buffer is not None
                              else state.class_prototypes.cpu()
                              if state.class_prototypes is not None else None)
                del state
            extra = ""
            if extras[0] is not None:
                ref, got = extras
                if name == "loss.ExperienceReplay":
                    assert torch.equal(torch.isfinite(ref), torch.isfinite(got))
                    ok = torch.isfinite(ref)
                    assert int(ok.sum()) == slots, int(ok.sum())
                    ref, got = ref[ok], got[ok]
                rel = float((got - ref).abs().max() / ref.abs().max())
                assert rel <= 1e-4, (name, rel)
                extra = (f"; {'buffer importances' if name.endswith('Replay') else 'class prototypes'}"
                         f" max rel err {rel:.3g}")
            hold_step(f"[25] f32 {name} step card vs CPU, RN101 {n} x {crop}^2, task 1",
                      activation, runs[1], runs[0], p0, extra)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def more_steps_512(cfg, params, stats, seed, dev, reset_counts, counts) -> dict:
    """[26] per method at 512^2 in bf16, batch 12: task 0's ``end_task``
    (ER's buffer population over ER_FILL_BATCHES batches, timed; SDR and
    iCaRL snapshot the previous model), the imprinting, the task-1 eval
    steps (``MORE_EVAL_LAUNCHES``, finite losses), then 2 warm-up and
    MORE_STEPS timed task-1 steps with the counters reset just before, the
    launches asserted per step (``MORE_STEP_LAUNCHES``), a finite loss, a
    profile by kernel kind, the busy time and the peak memory.  Returns,
    per method, the launch counts of the timed steps and of the eval steps
    and the numbers logged."""
    from bacs_tpu_torch.train.learner import multihead_init

    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    n_cls = OLD_CLASSES + 1
    results = {}
    for name in MORE_METHODS:
        ctx0, method, _ = more_steps(name, 0, dev)
        state = more_state(cfg, params, stats, torch.bfloat16, dev, name, ctx0, method,
                           seed=seed)
        fill = [synthetic_batch(MIB_PLOP_BATCH, CROP, gen, dev, OLD_CLASSES)
                for _ in range(ER_FILL_BATCHES)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = method.end_task(state, ctx0, fill)
        torch.cuda.synchronize()
        t_end = time.perf_counter() - t0
        note = ""
        if state.buffer is not None:
            buf = state.buffer
            n_valid = int(buf.valid.sum())
            note = (f"; buffer {n_valid} valid of {buf.size} (task 0's partition "
                    f"{method.buffer_size}), num_seen {buf.num_seen}")
            assert n_valid == method.buffer_size and bool(buf.valid[:n_valid].all())
            assert buf.num_seen == MIB_PLOP_BATCH * -(-method.buffer_size // MIB_PLOP_BATCH)
        else:
            assert state.prev_model is not None
        log(f"[26] {name} end_task of task 0 over up to {ER_FILL_BATCHES} batches of "
            f"{MIB_PLOP_BATCH} at {CROP}^2: {t_end:.3f} s{note}")
        del fill
        ctx1, _, (train_step, eval_step, _) = more_steps(name, 1, dev)
        multihead_init(state, ctx1.task)
        # the task-1 eval steps at the boundary, before the train steps: a
        # few bf16 train steps of this random network can grow its
        # eval-mode outputs past the finite range (the first card run of
        # this phase: ER's eval loss after its steps)
        batches = [synthetic_batch(MIB_PLOP_BATCH, CROP, gen, dev, n_cls)
                   for _ in range(MORE_STEPS)]
        conf_mat = torch.zeros((N_CLASSES, N_CLASSES), dtype=torch.int32, device=dev)
        eval_step(state, conf_mat.clone(), batches[0])  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        eval_losses = []
        for b in batches[:EVAL_STEPS]:
            conf_mat, loss = eval_step(state, conf_mat, b)
            eval_losses.append(float(loss))
        ev = counts()
        valid = sum(int((b["label"] != 255).sum()) for b in batches[:EVAL_STEPS])
        eval_busy = busy_ms(lambda: eval_step(state, conf_mat.clone(), batches[0]))
        log(f"[26] bf16 {name} eval step at task 1, batch {MIB_PLOP_BATCH}: launches {ev} "
            f"over {EVAL_STEPS} steps; losses {[round(v, 4) for v in eval_losses]}; "
            f"confusion counts {int(conf_mat.sum())} of {valid} valid pixels; device busy "
            f"{eval_busy:.3f} ms per step")
        assert all(np.isfinite(eval_losses)), eval_losses
        assert int(conf_mat.sum()) == valid
        want = MORE_EVAL_LAUNCHES[name]
        assert ev == {k: want.get(k, 0) * EVAL_STEPS for k in ev}, (name, ev)
        losses = []
        for _ in range(WARMUP_STEPS):
            state, metrics = train_step(state, synthetic_batch(MIB_PLOP_BATCH, CROP, gen, dev,
                                                               n_cls))
            losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        step_ms = []
        for b in batches:
            t0 = time.perf_counter()
            state, metrics = train_step(state, b)
            losses.append(float(metrics["loss"]))  # a host read: synchronises
            step_ms.append(1000 * (time.perf_counter() - t0))
        got = counts()
        peak = torch.cuda.max_memory_allocated()
        med = float(np.median(step_ms))
        log(f"[26] bf16 {name} step (task 1), batch {MIB_PLOP_BATCH}, {CROP}^2: median "
            f"{med:.3f} ms ({MIB_PLOP_BATCH * 1000 / med:.2f} img/s; min {min(step_ms):.3f}, "
            f"max {max(step_ms):.3f} ms over {MORE_STEPS} steps); peak memory "
            f"{peak / 2**30:.3f} GiB; launches {got} over {MORE_STEPS} steps")
        log(f"[26] {name} loss: {' '.join(f'{v:.4f}' for v in losses)}")
        assert all(np.isfinite(losses)), losses
        want = MORE_STEP_LAUNCHES[name]
        assert got == {k: want.get(k, 0) * MORE_STEPS for k in got}, (name, got)
        busy, parts = profile_by_kind(lambda: train_step(state, batches[0]),
                                      f"bf16 {name} steps (batch {MIB_PLOP_BATCH}, {CROP}^2)")
        for part, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
            log(f"[p] {name} step by kernel kind: {ms:.3f} ms ({ms / busy:.1%}) {part}")
        log(f"[p] {name}: device busy {busy:.3f} ms per step; median step wall {med:.3f} ms: "
            f"device idle share {1 - busy / med:.3f}; peak {peak / 2**30:.3f} GiB")

        results[name] = dict(steps=got, eval=ev, busy=busy, med=med, peak=peak, t_end=t_end,
                             eval_busy=eval_busy)
        del state, batches
        torch.cuda.empty_cache()
    return results


# [27] the flagship protocol through the port's runner, cut in depth: one
# epoch a task, 96 train and 64 validation images (every task's train and
# validation subsets non-empty: 95/16-23 and 63/10-16 images), crop 256,
# DeepLabV3-RN50, f32 as the protocol runs it
RUNNER_ARGS = ["--protocol", "15-1-flagship", "--methods", "er,sdr,icarl", "--epochs", "1",
               "--override", "dataset.dataset.n_train=96",
               "--override", "dataset.dataset.n_val=64"]


def runner_protocol(seed: int) -> dict:
    """[27] ``bacs_tpu_torch.protocol_compare.main`` in-process on the card
    for ER, SDR and iCaRL: every leg's JSON record has the runner's keys,
    one Avg-IoU per task (6) and finite mIoUs, and every train step a
    finite loss.  Returns the records, the losses per leg and the wall."""
    from unittest import mock

    from bacs_tpu_torch import protocol_compare
    from bacs_tpu_torch.train import loop

    losses = []
    make_steps = loop.make_steps

    def recording_steps(ctx, *a, **k):
        train_step, eval_step, put_batch = make_steps(ctx, *a, **k)

        def step(state, batch):
            state, out = train_step(state, batch)
            losses.append((ctx.task.task_id, float(out["loss"])))
            return state, out
        return step, eval_step, put_batch

    out = io.StringIO()
    t0 = time.perf_counter()
    with mock.patch.object(loop, "make_steps", recording_steps), \
            contextlib.redirect_stdout(out):
        results = protocol_compare.main(RUNNER_ARGS + ["--seed", str(42 + seed)])
    wall = time.perf_counter() - t0
    keys = {"method", "final_miou", "oldest_task_miou", "task0_miou",
            "avg_iou_per_dataset", "seconds"}
    records = [json.loads(line) for line in out.getvalue().splitlines()
               if line.startswith("{")]
    assert records == results and [r["method"] for r in records] == ["er", "sdr", "icarl"]
    for r in records:
        assert set(r) == keys, r
        assert len(r["avg_iou_per_dataset"]) == N_TASKS, r
        assert all(np.isfinite(r[k]) and 0 <= r[k] <= 1
                   for k in ("final_miou", "oldest_task_miou", "task0_miou")), r
    assert losses and all(np.isfinite(v) for _, v in losses), losses
    per_task = [sum(1 for t, _ in losses if t == k) for k in range(N_TASKS)]
    assert per_task[0] >= 3 * 5 and all(c >= 3 for c in per_task[1:]), per_task
    return dict(records=records, losses=losses, per_task=per_task, wall=wall)


# ---------------------------------------------------------------- UNet, accumulation, remat

UNET_YAML = "conf/experiments/network/unet.yaml"
UNET_BACS_BATCH, UNET_BACS_REPLAY, UNET_BACS_SLOTS = 8, 4, 16
UNET_STEPS, UNET_WARMUP = 10, 2
# [30]'s accumulated step: batch 8, two mini-steps an update
ACC_BATCH, ACC_K, ACC_STEPS = 8, 2, 8
# [31]'s remat turns: off, on, on, off; steps a turn after one warm-up
REMAT_TURNS, REMAT_STEPS = (False, True, True, False), 4
# [32] the 3-task protocol (UNet-3) through the port's runner, one epoch
UNET_RUNNER_ARGS = ["--protocol", "3task", "--methods", "ce,mib,bacs", "--epochs", "1"]


def unet_cfg(layers: int = 5) -> dict:
    """The shipped UNet config (64-512 channels, bilinear) at ``layers``."""
    return {**load_yaml(UNET_YAML), "num_layers": layers}


def unet_variables(cfg: dict, seed: int, use_bg_detector: bool = False):
    """Flax-layout (params, batch_stats) of a UNet drawn as the Trainer
    draws it (``train.loop.init_weights``: LeCun normal over the fan-in,
    biases 0), its running statistics calibrated by one small CPU forward
    (each norm's to its input's), as ``seeded_variables`` does."""
    from bacs_tpu_torch.data.transforms import normalize_image
    from bacs_tpu_torch.models import create_network
    from bacs_tpu_torch.train.loop import init_weights
    from bacs_tpu_torch.utils.flax_weights import state_dict_to_flax

    model = create_network(cfg["_target_"], N_CLASSES, n_tasks=N_TASKS,
                           use_bg_detector=use_bg_detector,
                           **{k: v for k, v in cfg.items() if k in NET_KEYS}).eval()
    init_weights(model, seed)
    img = torch.randint(0, 256, (2, 128, 128, 3), generator=torch.Generator().manual_seed(seed),
                        dtype=torch.uint8)
    calibrate_norms(model, normalize_image(img))
    return state_dict_to_flax(model.state_dict())


def unet_step_card_vs_cpu(seed, dev) -> None:
    """[28] one f32 CE train step of UNet-4 at 4 x 128^2 on the card and on
    the CPU (TF32 off), held by ``hold_step`` (ReLU: the norm rule of the
    leaky steps, as a kink within rounding moves a channel's gradient
    through its batch norm); then the eval step on both: loss rtol 1e-5,
    the confusion matrices counting every valid pixel, at most 1e-3 of
    them differently (argmax near-ties)."""
    cfg = unet_cfg(4)
    params, stats = unet_variables(cfg, seed)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = synthetic_batch(4, 128, torch.Generator().manual_seed(seed), "cpu")
    runs, evals = [], []  # the card's, then the CPU's
    for device in (dev, torch.device("cpu")):
        state = train_state(cfg, params, stats, torch.float32, device)
        p0 = {k: p.detach().cpu().clone() for k, p in state.model.named_parameters()}
        train_step, eval_step, put_batch = ce_steps(device)
        batch = put_batch(small)
        state, metrics = train_step(state, batch)
        runs.append((float(metrics["loss"]), *grads_and_stats(state.model)))
        cm = torch.zeros((N_CLASSES, N_CLASSES), dtype=torch.int32, device=device)
        cm, loss = eval_step(state, cm, batch)
        evals.append((cm.cpu(), float(loss)))
        del state
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    hold_step("[28] f32 UNet-4 CE step card vs CPU, 4 x 128^2", "ReLU", *runs, p0)
    (cm_g, loss_g), (cm_c, loss_c) = evals
    valid = int((small["label"] != 255).sum())
    moved = int((cm_g - cm_c).abs().sum()) // 2
    log(f"[28] eval step card vs CPU: loss {loss_g:.7f} vs {loss_c:.7f}; {moved} of {valid} "
        "pixels counted differently")
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c), (loss_g, loss_c)
    assert int(cm_g.sum()) == int(cm_c.sum()) == valid and moved <= 1e-3 * valid
    torch.cuda.empty_cache()


def unet_full_width(seed, dev, reset_counts, counts) -> dict:
    """[29] UNet-5 at the shipped width (``conf/experiments/network/unet.yaml``),
    512^2, bf16 convolutions on f32 master weights, on the class-coloured
    synthetic batches: CE train steps at batch 16 (a falling loss, no
    kernel launched: UNet's logits are at label resolution, so the CE is
    composed and the norms are plain batch norms; wall, peak memory and a
    profile by kernel kind), eval steps (no kernel launched; busy time),
    serving through the Predictor (exactly one K10 at scale 1 and no K5 per
    forward; img/s; K10 at [16, 512, 512, 21] held to its plain version and
    timed beside it and its bound), and a task-1 BACS step with the
    detector (batch 8, replay 2 x 4 from a 16-slot buffer filled by task
    0's ``end_task``; a finite loss, launches counted)."""
    from bacs_tpu_torch.ops.upsample_argmax import argmax_conf_from, upsampled_argmax_conf
    from bacs_tpu_torch.serve import Predictor

    out = {}
    cfg = unet_cfg(5)
    params, stats = unet_variables(cfg, seed)
    state = train_state(cfg, params, stats, torch.bfloat16, dev)
    train_step, eval_step, _ = ce_steps(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 29)
    batches = [synthetic_batch(BATCH, CROP, gen, dev) for _ in range(UNET_STEPS)]
    losses = []
    for b in batches[:UNET_WARMUP]:
        state, metrics = train_step(state, b)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms = []
    for b in batches[UNET_WARMUP:]:
        t0 = time.perf_counter()
        state, metrics = train_step(state, b)
        losses.append(float(metrics["loss"]))
        step_ms.append(1000 * (time.perf_counter() - t0))
    out["train_counts"] = counts()
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(step_ms))
    log(f"[29] UNet-5 bf16 CE train step, batch {BATCH}, {CROP}^2: median {med:.3f} ms "
        f"({BATCH * 1000 / med:.2f} img/s; min {min(step_ms):.3f}, max {max(step_ms):.3f} "
        f"over {len(step_ms)} steps); peak memory {peak / 2**30:.3f} GiB; launches "
        f"{out['train_counts']}")
    log(f"[29] loss curve: {' '.join(f'{v:.4f}' for v in losses)}")
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), "the loss did not fall"
    assert not any(out["train_counts"].values()), out["train_counts"]
    busy, parts = profile_by_kind(lambda: train_step(state, batches[0]),
                                  f"UNet-5 bf16 CE train steps (batch {BATCH}, {CROP}^2)")
    for part, ms in parts.items():
        log(f"[p] UNet-5 train step by kind: {ms:.3f} ms ({ms / busy:.1%}) {part}")
    log(f"[p] UNet-5 train: device busy {busy:.3f} ms per step; median wall {med:.3f} ms: "
        f"device idle share {1 - busy / med:.3f}")
    out["train"] = dict(wall=med, busy=busy, peak=peak / 2**30)

    cm = torch.zeros((N_CLASSES, N_CLASSES), dtype=torch.int32, device=dev)
    eval_step(state, cm.clone(), batches[0])
    torch.cuda.synchronize()
    reset_counts()
    eval_ms = []
    for b in batches[:EVAL_STEPS]:
        t0 = time.perf_counter()
        cm, loss = eval_step(state, cm, b)
        assert np.isfinite(float(loss)), float(loss)
        eval_ms.append(1000 * (time.perf_counter() - t0))
    out["eval_counts"] = counts()
    valid = sum(int((b["label"] != 255).sum()) for b in batches[:EVAL_STEPS])
    assert int(cm.sum()) == valid and not any(out["eval_counts"].values())
    eval_busy = busy_ms(lambda: eval_step(state, cm.clone(), batches[0]))
    log(f"[29] UNet-5 eval step, batch {BATCH}: median wall {np.median(eval_ms):.3f} ms, "
        f"device busy {eval_busy:.3f} ms; every valid pixel counted; no kernel launched")
    out["eval"] = dict(wall=float(np.median(eval_ms)), busy=eval_busy)
    del state
    torch.cuda.empty_cache()

    # serving: K10 at scale 1
    pred = Predictor(cfg, N_CLASSES, params, stats, crop_size=CROP, dtype=torch.bfloat16,
                     device=dev)
    rs = np.random.RandomState(seed + 29)
    served = [rs.randint(0, 256, (BATCH, CROP, CROP, 3)).astype(np.uint8) for _ in range(6)]
    for _ in pred.predict_many(served[:2]):
        pass
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = list(pred.predict_many(served))
    t_many = time.perf_counter() - t0
    out["serve_counts"] = counts()
    assert out["serve_counts"]["k10"] == len(served) and out["serve_counts"]["k5"] == 0, \
        out["serve_counts"]
    for preds, conf in results:
        assert preds.shape == (BATCH, CROP, CROP) and preds.max() < N_CLASSES
        assert bool(np.isfinite(conf.astype(np.float32)).all())
    x = torch.from_numpy(served[0]).to(dev)
    with torch.inference_mode():
        serve_busy = busy_ms(lambda: pred._infer(x))
    log(f"[29] UNet-5 bf16 serving, predict_many {len(served)} x {BATCH}: "
        f"{len(served) * BATCH / t_many:.2f} img/s, device busy {serve_busy:.3f} ms a batch; "
        f"launches {out['serve_counts']}")
    out["serve"] = dict(img_s=len(served) * BATCH / t_many, busy=serve_busy)
    with torch.inference_mode():
        from bacs_tpu_torch.data.transforms import normalize_image

        sem = pred.model.sem_logits(normalize_image(x).to(torch.bfloat16)).contiguous()
    del pred
    torch.cuda.empty_cache()
    shape, hw = tuple(sem.shape), (CROP, CROP)
    err = check_argmax(shape, hw, torch.bfloat16, dev, seed=seed)
    k10_x1 = (device_ms(lambda: upsampled_argmax_conf(sem, hw)),
              device_ms(lambda: argmax_conf_from(sem.float())))
    k10_x1_bound = upsample_bound("k10", sem, hw)
    log(f"[29] K10 at scale 1 {shape}->{hw} bf16: held to its plain version (conf max abs "
        f"err {err:.3g}); on the served logits kernel {k10_x1[0]:.4f} ms, plain "
        f"{k10_x1[1]:.4f} ms, bound {k10_x1_bound[0]:.4f} ms ({k10_x1_bound[1]})")
    out["k10_x1"] = dict(err=err, ms=k10_x1[0], plain_ms=k10_x1[1], bound=k10_x1_bound)

    # a task-1 BACS step with the detector
    params_d, stats_d = unet_variables(cfg, seed, use_bg_detector=True)
    dim = len(params_d["seen_fg_network"]["base_bn"]["scale"])
    state = train_state(cfg, params_d, stats_d, torch.bfloat16, dev,
                        generator=torch.Generator(dev).manual_seed(seed),
                        prototypes=torch.zeros((N_TASKS, dim), device=dev),
                        proto_counts=torch.zeros(N_TASKS, device=dev))
    kw = dict(buffer_size=UNET_BACS_SLOTS, replay_minibatch_size=UNET_BACS_REPLAY)
    ctx0, method, _ = bacs_steps(0, dev, **kw)
    state.buffer = method.init_buffer(ctx0.task, (CROP, CROP), (CROP, CROP), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 30)
    fill = [synthetic_batch(UNET_BACS_BATCH, CROP, gen, dev, n_classes=16) for _ in range(2)]
    state = method.end_task(state, ctx0, fill)
    assert int(state.buffer.valid.sum()) > 0
    _, _, (train1, _, _) = bacs_steps(1, dev, **kw)
    steps = [synthetic_batch(UNET_BACS_BATCH, CROP, gen, dev, n_classes=17) for _ in range(3)]
    state, metrics = train1(state, steps[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    bacs_losses, bacs_ms = [], []
    for b in steps[1:]:
        t0 = time.perf_counter()
        state, metrics = train1(state, b)
        bacs_losses.append(float(metrics["loss"]))
        bacs_ms.append(1000 * (time.perf_counter() - t0))
    out["bacs_counts"] = counts()
    bacs_peak = torch.cuda.max_memory_allocated()
    assert all(np.isfinite(bacs_losses)), bacs_losses
    assert not any(out["bacs_counts"].values()), out["bacs_counts"]
    bacs_busy = busy_ms(lambda: train1(state, steps[1]))
    log(f"[29] UNet-5 task-1 BACS step (detector, batch {UNET_BACS_BATCH} + replay 2 x "
        f"{UNET_BACS_REPLAY}): losses {' '.join(f'{v:.4f}' for v in bacs_losses)}; median "
        f"wall {np.median(bacs_ms):.3f} ms, device busy {bacs_busy:.3f} ms, peak "
        f"{bacs_peak / 2**30:.3f} GiB; launches {out['bacs_counts']} (every CE composed)")
    out["bacs"] = dict(wall=float(np.median(bacs_ms)), busy=bacs_busy,
                       peak=bacs_peak / 2**30)
    del state
    torch.cuda.empty_cache()
    return out


def accumulate_checks(cfg, params, stats, seed, dev, reset_counts, counts) -> dict:
    """[30] gradient accumulation (k = 2): a pair of f32 RN101 mini-steps at
    4 x 128^2 on the card and on the CPU (TF32 off), held by ``hold_step``
    with identity and leaky activations (the update runs on the mean
    gradient of the pair); then bf16 CE at 512^2, batch 8, two mini-steps
    an update: one optimizer step per two mini-steps (the schedule's
    count), train-ABN and K1 per mini-step, busy time a mini-step, peak."""
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(seed + 30)
    pair = [synthetic_batch(4, 128, g, "cpu") for _ in range(ACC_K)]
    for activation in ("identity", "leaky"):
        runs = []  # the card's, then the CPU's
        for device in (dev, torch.device("cpu")):
            state = train_state(cfg, params, stats, torch.float32, device,
                                smooth=activation == "identity", accumulate=ACC_K)
            p0 = {k: p.detach().cpu().clone() for k, p in state.model.named_parameters()}
            train_step, _, put_batch = ce_steps(device)
            losses = []
            for b in pair:
                state, metrics = train_step(state, put_batch(b))
                losses.append(float(metrics["loss"]))
            assert state.scheduler.last_epoch == 1 and state.step == ACC_K
            runs.append((float(np.mean(losses)), *grads_and_stats(state.model)))
            del state
        hold_step(f"[30] f32 RN101 pair of mini-steps (k = {ACC_K}) card vs CPU, 4 x 128^2",
                  activation, *runs, p0,
                  "; the loss is the pair's mean, the gradient the pair's mean, clipped")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()

    state = train_state(cfg, params, stats, torch.bfloat16, dev, accumulate=ACC_K)
    train_step, _, _ = ce_steps(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    batches = [synthetic_batch(ACC_BATCH, CROP, gen, dev) for _ in range(ACC_STEPS)]
    for b in batches[:ACC_K]:
        state, _ = train_step(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    updates0, wall = state.scheduler.last_epoch, []
    for b in batches:
        t0 = time.perf_counter()
        state, metrics = train_step(state, b)
        assert np.isfinite(float(metrics["loss"]))
        wall.append(1000 * (time.perf_counter() - t0))
    acc_counts = counts()
    peak = torch.cuda.max_memory_allocated()
    updates = state.scheduler.last_epoch - updates0
    assert updates == ACC_STEPS // ACC_K, updates
    assert acc_counts["train_abn"] == ABN_PER_FORWARD * ACC_STEPS
    assert acc_counts["k1f"] == acc_counts["k1b"] == ACC_STEPS
    busy = busy_ms(lambda: train_step(state, batches[0]), steps=ACC_K)
    log(f"[30] bf16 RN101 CE, batch {ACC_BATCH} x {ACC_K} mini-steps, {CROP}^2: {updates} "
        f"optimizer steps over {ACC_STEPS} mini-steps; median mini-step wall "
        f"{np.median(wall):.3f} ms, device busy {busy:.3f} ms a mini-step; peak "
        f"{peak / 2**30:.3f} GiB; launches {acc_counts}")
    del state
    torch.cuda.empty_cache()
    return dict(counts=acc_counts, busy=busy, wall=float(np.median(wall)), peak=peak / 2**30)


def remat_compare(cfg, params, stats, seed, dev, reset_counts, counts) -> dict:
    """[31] RN101 bf16 CE at 512^2, batch 16, ``remat=false`` against
    ``remat=true`` in turns (off, on, on, off), each turn a fresh state
    from the same weights on the same batches: the first step's loss
    equal, its gradients within bf16 rounding (norm rule 1e-2: the
    recompute may pick other cuDNN algorithms) and the running statistics
    after it within 1e-3 of their largest (updated once, not twice); per
    turn the peak memory, device busy time a step and train-ABN launches
    (the recompute runs every block's ABN a second time: 103 more)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    batches = [synthetic_batch(BATCH, CROP, gen, dev) for _ in range(REMAT_STEPS + 1)]
    turns, first = [], {}
    for remat in REMAT_TURNS:
        state = train_state({**cfg, "remat": remat}, params, stats, torch.bfloat16, dev)
        train_step, _, _ = ce_steps(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        state, metrics = train_step(state, batches[0])
        c = counts()
        grads, _, stats_after = grads_and_stats(state.model)
        first.setdefault(remat, (float(metrics["loss"]), grads, stats_after))
        for b in batches[1:]:
            state, metrics = train_step(state, b)
            assert np.isfinite(float(metrics["loss"]))
        peak = torch.cuda.max_memory_allocated()
        busy = busy_ms(lambda: train_step(state, batches[0]))
        turns.append(dict(remat=remat, peak=peak / 2**30, busy=busy, counts=c))
        log(f"[31] remat={remat}: peak {peak / 2**30:.3f} GiB, device busy {busy:.3f} ms a "
            f"step; launches of the first step {c}")
        del state
        torch.cuda.empty_cache()
    (loss_off, g_off, s_off), (loss_on, g_on, s_on) = first[False], first[True]
    grad_norm = norm_error(g_on, g_off)
    stats_rel, worst = max_rel_error(s_on, s_off)
    log(f"[31] remat against plain, first step: loss {loss_on:.6f} vs {loss_off:.6f}; "
        f"gradients norm rel err {grad_norm:.3g}; running statistics max rel err "
        f"{stats_rel:.3g} ({worst})")
    assert abs(loss_on - loss_off) <= 1e-6 * abs(loss_off), (loss_on, loss_off)
    assert grad_norm <= 1e-2 and stats_rel <= 1e-3, (grad_norm, stats_rel)
    on = [t for t in turns if t["remat"]]
    off = [t for t in turns if not t["remat"]]
    assert all(t["counts"]["train_abn"] == ABN_PER_FORWARD for t in off)
    # the recompute: every ABN but the stem's and the ASPP's three
    assert all(t["counts"]["train_abn"] == 2 * ABN_PER_FORWARD - 4 for t in on)
    return dict(turns=turns, grad_norm=grad_norm, stats_rel=stats_rel,
                counts={k: sum(t["counts"][k] for t in turns) for k in turns[0]["counts"]})


def unet_runner(seed: int) -> dict:
    """[32] ``bacs_tpu_torch.protocol_compare.main`` in-process on the card for
    the 3-task protocol (UNet-3, 32^2) with CE, MiB and BACS at one epoch a
    task: the runner's keys, 3 tasks, finite mIoUs in [0, 1]."""
    from bacs_tpu_torch import protocol_compare

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        results = protocol_compare.main(UNET_RUNNER_ARGS + ["--seed", str(42 + seed)])
    wall = time.perf_counter() - t0
    keys = {"method", "final_miou", "oldest_task_miou", "task0_miou",
            "avg_iou_per_dataset", "seconds"}
    records = [json.loads(line) for line in out.getvalue().splitlines()
               if line.startswith("{")]
    assert records == results and [r["method"] for r in records] == ["ce", "mib", "bacs"]
    for r in records:
        assert set(r) == keys and len(r["avg_iou_per_dataset"]) == 3, r
        assert all(np.isfinite(r[k]) and 0 <= r[k] <= 1
                   for k in ("final_miou", "oldest_task_miou", "task0_miou")), r
    return dict(records=records, wall=wall)


# ---------------------------------------------------------------- TranSeg

# conf/experiments/bacs_transformer_config.yaml: TranSeg (hidden 256, 8
# heads, 2 decoder layers, feed-forward 2048, RN101) with bacs_plus and
# der_15_1_transformer (TransformerLearner, new_token_init mean, the
# detector, batch 12)
TRANSEG_YAML = "conf/experiments/network/deep_lab_transformer.yaml"
TRANSEG_CONFIG = ("conf/experiments", "bacs_transformer_config")
TRANSEG_ABN = ABN_PER_FORWARD - 3  # DeepLabV3's less the ASPP's 3: the backbone's
TRANSEG_BATCH, TRANSEG_STEPS, TRANSEG_FILL = 12, 4, 4
# [35] the protocol through the CLI on [24]'s synthetic source cut to 200
# training images (every task keeps 17-29, task 0 15 steps; the
# run's time), no checkpoints
TRANSEG_OVERRIDES = ["+network.fused_stem=true",
                     "dataset._target_=dataloaders.SyntheticDataModule",
                     "+dataset.dataset.n_train=200", "+dataset.dataset.n_val=48",
                     "+training.steps_per_class=1", "training.epochs=1",
                     "~training.ckpt_dir"]


def launch_counters():
    """(reset_counts, counts) over every wrapper's launch counter."""
    from bacs_tpu_torch.ops.abn_core import fused_abn, fused_abn_eval
    from bacs_tpu_torch.ops.stem_pool import stem_pool_fwd, stem_pool_grad
    from bacs_tpu_torch.ops.upsample_argmax import upsampled_argmax_conf
    from bacs_tpu_torch.ops.upsample_ce import (
        bacs_dsem, bacs_sum, ce_dsem, ce_dsem_per_image, ce_sums_per_image, uce_dsem,
        uce_sums, ukd_dsem, ukd_sum, wce_dsem, wce_sums)
    from bacs_tpu_torch.ops.upsample_confusion import upsampled_confusion
    from bacs_tpu_torch.ops.upsample_pseudo import plop_pseudo_labels

    counters = dict(k5=fused_abn_eval, train_abn=fused_abn, k1f=ce_sums_per_image,
                    k1b=ce_dsem, k2=upsampled_confusion, k10=upsampled_argmax_conf,
                    k3f=bacs_sum, k3b=bacs_dsem, k4f=wce_sums, k4b=wce_dsem,
                    k6f=uce_sums, k6b=uce_dsem, k7f=ukd_sum, k7b=ukd_dsem,
                    k8=ce_dsem_per_image, k9=plop_pseudo_labels, k12f=stem_pool_fwd,
                    k12b=stem_pool_grad)

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    return reset_counts, counts


def transeg_cfg() -> dict:
    """The shipped TranSeg network config (its null keys dropped)."""
    return {k: v for k, v in load_yaml(TRANSEG_YAML).items() if v is not None}


def transeg_variables(cfg: dict, seed: int, use_bg_detector: bool = False,
                      smooth: bool = False, crop: int = CROP, active_classes=None):
    """Flax-layout (params, batch_stats) of a TranSeg: the head drawn as the
    Trainer draws it (``train.loop.init_weights``: Flax's initialisers),
    the backbone's convolutions He normal and its ABN vectors spread as
    ``seeded_variables`` does (each bottleneck's last scale small), the
    running statistics calibrated by one small CPU forward (for identity
    activations if ``smooth``)."""
    from bacs_tpu_torch.data.transforms import normalize_image
    from bacs_tpu_torch.models import ABN, create_network
    from bacs_tpu_torch.train.loop import init_weights
    from bacs_tpu_torch.utils.flax_weights import state_dict_to_flax

    model = create_network(cfg["_target_"], N_CLASSES, n_tasks=N_TASKS,
                           use_bg_detector=use_bg_detector, crop_size=crop,
                           active_classes=active_classes,
                           **{k: v for k, v in cfg.items() if k in NET_KEYS}).eval()
    init_weights(model, seed)
    g = torch.Generator().manual_seed(seed + 33)
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, ABN):
                lo, span = (0.1, 0.2) if name.endswith("bn3") else (0.5, 1.0)
                m.weight.copy_(lo + span * torch.rand(m.weight.shape, generator=g))
                m.bias.copy_((torch.rand(m.bias.shape, generator=g) - 0.5) * 0.2)
                if smooth:
                    m.activation, m.slope = "identity", 1.0
    img = torch.randint(0, 256, (4, 128, 128, 3), generator=g, dtype=torch.uint8)
    calibrate_norms(model, normalize_image(img), full=use_bg_detector)
    return state_dict_to_flax(model.state_dict())


def transeg_state(cfg, variables, dtype, device, smooth=False, crop=CROP, active=None,
                  **state_kw):
    """``train_state`` for TranSeg at crop ``crop`` with ``active`` class
    tokens in use, the detector's dropout off."""
    state = train_state(cfg, *variables, dtype, device, smooth=smooth, crop_size=crop,
                        active_classes=active, **state_kw)
    if hasattr(state.model, "seen_fg_network"):
        state.model.seen_fg_network.dropout_rate = 0.0
    return state


def token_growth_ok(model, task) -> bool:
    """The ``mean`` growth of ``task``'s new class tokens: each equal to the
    mean of the old ones, their ``mask_norm`` entries 1 and 0."""
    head = model.base_classifier
    lo, hi = task.old_classes, task.nb_current_classes
    mean = head.class_tokens[:lo].mean(dim=0)
    return (bool(torch.equal(head.class_tokens[lo:hi], mean.expand(hi - lo, -1)))
            and bool((head.mask_norm_scale[lo:hi] == 1).all())
            and bool((head.mask_norm_bias[lo:hi] == 0).all()))


def transeg_step_card_vs_cpu(seed, dev) -> None:
    """[33] f32 TranSeg steps at RN101 4 x 128^2 with the shipped head, on the
    card and on the CPU (TF32 off), with identity and with the leaky
    activations: a task-0 CE step (16 of 21 class tokens; the eval step on
    its batch before it: loss rtol 1e-5, at most 1e-3 of the pixels counted
    differently, argmax near-ties), then the task-1 BACS+ step after task 0's
    ``end_task`` (run once on the CPU and copied to both devices: the
    snapshot, the prototypes, the buffer, the drifted statistics), the
    ``mean`` token growth on each device and 17 tokens on the model and on
    the previous model, replay draws injected as [13] does.  Held by
    ``hold_step``; the prototypes to 1e-4."""
    import copy

    from bacs_tpu_torch.methods import ModelContext, create_method
    from bacs_tpu_torch.train.learner import transformer_init
    from bacs_tpu_torch.train.state import TaskInfo, frozen_copy
    from bacs_tpu_torch.train.step import make_steps

    cfg, crop, n, replay, slots = transeg_cfg(), 128, 4, 4, 8
    task0, task1 = (TaskInfo(task_id=t, **BACS_TASK) for t in (0, 1))
    gen = torch.Generator().manual_seed(seed + 33)
    batch0 = synthetic_batch(n, crop, gen, "cpu", n_classes=16)
    batch1 = synthetic_batch(n, crop, gen, "cpu", n_classes=17)
    fill = synthetic_batch(slots - 2, crop, gen, "cpu", n_classes=16)
    keys = [-torch.log(-torch.log(torch.rand(slots, generator=gen))) for _ in range(2)]
    crop_params = dict(i=torch.tensor([3.5, 0.0, 40.25, 0.0]),
                       j=torch.tensor([0.0, 17.0, 2.5, 0.0]),
                       ch=torch.tensor([80.0, 128.0, 61.0, 128.0]),
                       cw=torch.tensor([105.0, 66.0, 120.0, 128.0]),
                       flip=torch.tensor([True, False, False, True]))
    kw = dict(buffer_size=slots, replay_minibatch_size=replay)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for activation in ("identity", "leaky"):
        smooth = activation == "identity"
        variables = transeg_variables(cfg, seed, True, smooth=smooth, crop=crop,
                                      active_classes=16)
        dim = len(variables[0]["seen_fg_network"]["base_bn"]["scale"])
        # task 0: CE, then the eval step
        runs, evals = [], []
        for device in (dev, torch.device("cpu")):
            state = transeg_state(cfg, variables, torch.float32, device, smooth, crop, 16)
            p0 = {k: p.detach().cpu().clone() for k, p in state.model.named_parameters()}
            train_step, eval_step, put_batch = make_steps(
                ModelContext(task0), create_method("loss.CrossEntropy"), N_CLASSES,
                device=device)
            b = put_batch(batch0)
            cm = torch.zeros((N_CLASSES, N_CLASSES), dtype=torch.int32, device=device)
            cm, loss = eval_step(state, cm, b)
            evals.append((cm.cpu(), float(loss)))
            state, metrics = train_step(state, b)
            runs.append((float(metrics["loss"]), *grads_and_stats(state.model)))
            del state
        hold_step(f"[33] f32 TranSeg task-0 CE step card vs CPU, RN101 {n} x {crop}^2, "
                  "16 of 21 class tokens", activation, *runs, p0)
        (cm_g, loss_g), (cm_c, loss_c) = evals
        valid = int((batch0["label"] != 255).sum())
        moved = int((cm_g - cm_c).abs().sum()) // 2
        log(f"[33] task-0 eval step card vs CPU, {activation}: loss {loss_g:.7f} vs "
            f"{loss_c:.7f}; {moved} of {valid} pixels counted differently")
        assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c), (loss_g, loss_c)
        assert int(cm_g.sum()) == int(cm_c.sum()) == valid and moved <= 1e-3 * valid

        # task 0's end_task once, on the CPU
        _, method, _ = bacs_steps(0, "cpu", **kw)
        state = transeg_state(cfg, variables, torch.float32, "cpu", smooth, crop, 16,
                              generator=torch.Generator().manual_seed(seed),
                              prototypes=torch.zeros((N_TASKS, dim)),
                              proto_counts=torch.zeros(N_TASKS))
        state.buffer = method.init_buffer(task0, (crop, crop), (crop // 16, crop // 16),
                                          device="cpu")
        state = method.end_task(state, ModelContext(task0), [fill])
        after = copy.deepcopy(state)
        del state
        runs = []
        for device in (dev, torch.device("cpu")):
            state = transeg_state(
                cfg, variables, torch.float32, device, smooth, crop, 16,
                generator=torch.Generator(device).manual_seed(seed),
                prototypes=after.prototypes.to(device),
                proto_counts=after.proto_counts.to(device), buffer=after.buffer.to(device))
            state.model.load_state_dict(after.model.state_dict())
            state.prev_model = frozen_copy(state.model)
            state.prev_model.load_state_dict(after.prev_model.state_dict())
            transformer_init(state, task1, "mean")
            assert token_growth_ok(state.model, task1)
            state.model.active_classes = state.prev_model.active_classes = 17
            p0 = {k: p.detach().cpu().clone() for k, p in state.model.named_parameters()}
            _, _, (train_step, eval_step, put_batch) = bacs_steps(1, device, **kw)
            b = put_batch(batch1)
            with injected_draws([k.to(device) for k in keys], crop_params):
                state, metrics = train_step(state, b)
            runs.append((float(metrics["loss"]), *grads_and_stats(state.model),
                         state.prototypes.cpu()))
            del state
        (loss_g, grads_g, params_g, stats_g, protos_g), (
            loss_c, grads_c, params_c, stats_c, protos_c) = runs
        proto_rel = float((protos_g - protos_c).abs().max() / protos_c.abs().max())
        hold_step(f"[33] f32 TranSeg task-1 BACS+ step card vs CPU, RN101 {n} x {crop}^2, "
                  f"mean token growth, 17 tokens, replay {replay}", activation,
                  (loss_g, grads_g, params_g, stats_g), (loss_c, grads_c, params_c, stats_c),
                  p0, f"; prototypes {proto_rel:.3g}")
        assert proto_rel <= 1e-4, proto_rel
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()


def f32_kernel_checks(dev, seed) -> dict:
    """[34] K1, K2, K10 at TranSeg's CE, eval and serving shapes and K3, K4 at
    its BACS+ step's (main and dark++ replay batch of 12), float32, held to
    their plain versions, then timed (CUDA-graph replay; the plain K1-K4
    versions by events, as [t]) beside their bounds.  Returns {key:
    (max abs err, ms, plain ms, bound)}."""
    from bacs_tpu_torch.ops.upsample_argmax import argmax_conf_from, upsampled_argmax_conf
    from bacs_tpu_torch.ops.upsample_ce import (
        bacs_dsem, bacs_dsem_plain, bacs_sum, bacs_sum_plain, ce_dsem, ce_dsem_plain,
        ce_sums_per_image, ce_sums_plain, wce_dsem, wce_dsem_plain, wce_sums,
        wce_sums_plain)
    from bacs_tpu_torch.ops.upsample_confusion import confusion_plain, upsampled_confusion
    from bacs_tpu_torch.ops.upsample_tiles import kmats

    f32, hw = torch.float32, (CROP, CROP)
    main = (BATCH, CROP // 16, CROP // 16, N_CLASSES)
    bacs = (TRANSEG_BATCH, CROP // 16, CROP // 16, 17)
    errs = {}
    e = check_ce(main, hw, f32, dev, seed)
    errs["k1f"], errs["k1b"] = e["val_abs"], e["grad_abs"]
    errs["k2"] = check_confusion(main, hw, f32, dev, seed)
    errs["k10"] = check_argmax(main, hw, f32, dev, seed)
    e = check_bacs(bacs, hw, f32, dev, seed=seed)
    errs["k3f"], errs["k3b"] = e["val_abs"], e["grad_abs"]
    e = check_wce(bacs, hw, f32, dev, seed=seed)
    errs["k4f"], errs["k4b"] = e["val_abs"], e["grad_abs"]
    log(f"[34] K1, K2, K10 at {main}->{CROP}^2 and K3, K4 at {bacs}->{CROP}^2, float32: "
        f"held to their plain versions; max abs errors {errs} (K2: pixels counted "
        "differently)")

    gen = torch.Generator(device=dev).manual_seed(seed + 34)
    labels = synthetic_batch(BATCH, CROP, gen, dev)["label"]
    sem = torch.randn(main, generator=gen, device=dev) * 3
    lab3 = synthetic_batch(TRANSEG_BATCH, CROP, gen, dev, n_classes=17)["label"]
    sem3 = torch.randn(bacs, generator=gen, device=dev) * 3
    seen = torch.rand(lab3.shape, generator=gen, device=dev)
    w4 = beta_weights(17, dev)
    g1 = torch.tensor(1.0 / float((labels != 255).sum()), device=dev)
    g3 = torch.tensor(1.0 / lab3.numel(), device=dev)
    g4 = (1.0 / wce_sums_plain(sem3, lab3, w4, hw)[1]).reshape(())
    kh, kw = (torch.from_numpy(k).to(dev) for k in kmats(sem.shape, hw))
    calls = {
        "k1f": (lambda: ce_sums_per_image(sem, labels, hw),
                lambda: ce_sums_plain(sem, labels, hw), (sem, labels, None)),
        "k1b": (lambda: ce_dsem(sem, labels, hw, g1),
                lambda: ce_dsem_plain(sem, labels, hw, g1), (sem, labels, None)),
        "k2": (lambda: upsampled_confusion(sem, labels, hw, N_CLASSES),
               lambda: confusion_plain(sem, labels, hw, N_CLASSES), (sem, labels, None)),
        "k3f": (lambda: bacs_sum(sem3, lab3, seen, hw, 16),
                lambda: bacs_sum_plain(sem3, lab3, seen, hw, 16), (sem3, lab3, seen)),
        "k3b": (lambda: bacs_dsem(sem3, lab3, seen, hw, g3, 16),
                lambda: bacs_dsem_plain(sem3, lab3, seen, hw, g3, 16), (sem3, lab3, seen)),
        "k4f": (lambda: wce_sums(sem3, lab3, w4, hw),
                lambda: wce_sums_plain(sem3, lab3, w4, hw), (sem3, lab3, w4)),
        "k4b": (lambda: wce_dsem(sem3, lab3, w4, hw, g4),
                lambda: wce_dsem_plain(sem3, lab3, w4, hw, g4), (sem3, lab3, w4)),
    }
    out = {}
    for key, (kernel, plain, (s, lab, extra)) in calls.items():
        out[key] = (errs[key], device_ms(kernel), time_ms(plain, iters=5),
                    upsample_bound(key, s, hw, lab, extra))
    out["k10"] = (errs["k10"], device_ms(lambda: upsampled_argmax_conf(sem, hw)),
                  device_ms(lambda: argmax_conf_from(torch.einsum(
                      "Ww,nHwc->nHWc", kw, torch.einsum("Hh,nhwc->nHwc", kh, sem)))),
                  upsample_bound("k10", sem, hw))
    for key, (err, ms, plain_ms, bnd) in out.items():
        log(f"[34] {key} float32 at TranSeg's shape: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), max abs err {err:.3g}")
    return out


def transeg_full_width(seed, dev, reset_counts, counts) -> dict:
    """[34] TranSeg at the shipped width (``conf/experiments/network/
    deep_lab_transformer.yaml``: RN101, hidden 256, 8 heads, 2 layers,
    feed-forward 2048), 512^2, bf16 convolutions and Dense layers on f32
    master weights, random seeded weights, the class-coloured synthetic
    batches: CE train steps at batch 16 on all 21 classes (per step 1 K1
    each way and 104 train-ABN; a falling loss; wall, busy, idle share,
    peak, a profile by kernel kind), eval steps (104 K5, 1 K1 forward, 1 K2
    a step), serving through the Predictor at batch 16 (104 K5 and 1 K10 a
    forward, on float32 logits), the f32 kernel checks and times
    (``f32_kernel_checks``), and task-1 BACS+ steps with the detector at 12
    + 2 x 12 replay after task 0's ``end_task`` and the ``mean`` token
    growth (per step 1 K3 and 1 K4 each way, 3 x 104 train-ABN, 104 K5 of
    the previous model)."""
    from bacs_tpu_torch.serve import Predictor
    from bacs_tpu_torch.train.learner import transformer_init

    out = {}
    cfg = transeg_cfg()
    # one draw for both networks: the CE network's is the detector's less
    # the detector
    det = transeg_variables(cfg, seed, use_bg_detector=True, active_classes=16)
    variables = tuple({k: v for k, v in tree.items() if k != "seen_fg_network"}
                      for tree in det)
    state = transeg_state(cfg, variables, torch.bfloat16, dev)
    train_step, eval_step, _ = ce_steps(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 34)
    batches = [synthetic_batch(BATCH, CROP, gen, dev) for _ in range(WARMUP_STEPS + 6)]
    losses = []
    for b in batches[:WARMUP_STEPS]:
        state, metrics = train_step(state, b)
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms = []
    for b in batches[WARMUP_STEPS:]:
        t0 = time.perf_counter()
        state, metrics = train_step(state, b)
        losses.append(float(metrics["loss"]))
        step_ms.append(1000 * (time.perf_counter() - t0))
    n = len(step_ms)
    out["train_counts"] = c = counts()
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(step_ms))
    log(f"[34] TranSeg bf16 CE train step, batch {BATCH}, {CROP}^2: median {med:.3f} ms "
        f"({BATCH * 1000 / med:.2f} img/s; min {min(step_ms):.3f}, max {max(step_ms):.3f} "
        f"over {n} steps); peak memory {peak / 2**30:.3f} GiB; launches {c}")
    log(f"[34] loss curve: {' '.join(f'{v:.4f}' for v in losses)}")
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), "the loss did not fall"
    assert c["k1f"] == c["k1b"] == n and c["train_abn"] == TRANSEG_ABN * n, c
    assert sum(v for k, v in c.items() if k not in ("k1f", "k1b", "train_abn")) == 0, c
    busy, parts = profile_by_kind(lambda: train_step(state, batches[0]),
                                  f"TranSeg bf16 CE train steps (batch {BATCH}, {CROP}^2)")
    for part, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
        log(f"[p] TranSeg train step by kind: {ms:.3f} ms ({ms / busy:.1%}) {part}")
    log(f"[p] TranSeg train: device busy {busy:.3f} ms per step; median wall {med:.3f} ms: "
        f"device idle share {1 - busy / med:.3f}")
    out["train"] = dict(wall=med, busy=busy, peak=peak / 2**30)

    cm = torch.zeros((N_CLASSES, N_CLASSES), dtype=torch.int32, device=dev)
    eval_step(state, cm.clone(), batches[0])
    torch.cuda.synchronize()
    reset_counts()
    eval_ms = []
    for b in batches[:EVAL_STEPS]:
        t0 = time.perf_counter()
        cm, loss = eval_step(state, cm, b)
        assert np.isfinite(float(loss)), float(loss)
        eval_ms.append(1000 * (time.perf_counter() - t0))
    out["eval_counts"] = c = counts()
    valid = sum(int((b["label"] != 255).sum()) for b in batches[:EVAL_STEPS])
    assert int(cm.sum()) == valid, (int(cm.sum()), valid)
    assert c["k5"] == TRANSEG_ABN * EVAL_STEPS and c["k1f"] == c["k2"] == EVAL_STEPS, c
    assert sum(v for k, v in c.items() if k not in ("k5", "k1f", "k2")) == 0, c
    eval_busy = busy_ms(lambda: eval_step(state, cm.clone(), batches[0]))
    log(f"[34] TranSeg eval step, batch {BATCH}: median wall {np.median(eval_ms):.3f} ms, "
        f"device busy {eval_busy:.3f} ms; every valid pixel counted; launches {c}")
    out["eval"] = dict(wall=float(np.median(eval_ms)), busy=eval_busy)
    del state
    torch.cuda.empty_cache()

    pred = Predictor(cfg, N_CLASSES, *variables, crop_size=CROP, dtype=torch.bfloat16,
                     device=dev)
    rs = np.random.RandomState(seed + 34)
    served = [rs.randint(0, 256, (BATCH, CROP, CROP, 3)).astype(np.uint8) for _ in range(6)]
    for _ in pred.predict_many(served[:2]):
        pass
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    results = list(pred.predict_many(served))
    t_many = time.perf_counter() - t0
    out["serve_counts"] = c = counts()
    assert c["k10"] == len(served) and c["k5"] == TRANSEG_ABN * len(served), c
    for preds, conf in results:
        assert preds.shape == (BATCH, CROP, CROP) and preds.max() < N_CLASSES
        assert bool(np.isfinite(conf.astype(np.float32)).all())
    x = torch.from_numpy(served[0]).to(dev)
    with torch.inference_mode():
        from bacs_tpu_torch.data.transforms import normalize_image

        served_sem = pred.model.sem_logits(normalize_image(x).to(torch.bfloat16))
        serve_busy = busy_ms(lambda: pred._infer(x))
    assert served_sem.dtype == torch.float32, served_sem.dtype
    log(f"[34] TranSeg bf16 serving, predict_many {len(served)} x {BATCH}: "
        f"{len(served) * BATCH / t_many:.2f} img/s, device busy {serve_busy:.3f} ms a batch; "
        f"K10 on {tuple(served_sem.shape)} {served_sem.dtype}; launches {c}")
    out["serve"] = dict(img_s=len(served) * BATCH / t_many, busy=serve_busy)
    del pred, served_sem
    torch.cuda.empty_cache()

    out["f32"] = f32_kernel_checks(dev, seed)

    # task 1 of BACS+ with the detector: task 0's end_task, the token growth
    dim = len(det[0]["seen_fg_network"]["base_bn"]["scale"])
    state = transeg_state(cfg, det, torch.bfloat16, dev, active=16,
                          generator=torch.Generator(dev).manual_seed(seed),
                          prototypes=torch.zeros((N_TASKS, dim), device=dev),
                          proto_counts=torch.zeros(N_TASKS, device=dev))
    state.model.seen_fg_network.dropout_rate = 0.1  # as shipped
    kw = dict(replay_minibatch_size=TRANSEG_BATCH)
    ctx0, method, _ = bacs_steps(0, dev, **kw)
    state.buffer = method.init_buffer(ctx0.task, (CROP, CROP), (CROP // 16, CROP // 16),
                                      device=dev)
    fill = [synthetic_batch(TRANSEG_BATCH, CROP, gen, dev, n_classes=16)
            for _ in range(TRANSEG_FILL)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = method.end_task(state, ctx0, fill)
    torch.cuda.synchronize()
    t_end = time.perf_counter() - t0
    ctx1, _, (bacs_train, _, _) = bacs_steps(1, dev, **kw)
    transformer_init(state, ctx1.task, "mean")
    assert token_growth_ok(state.model, ctx1.task)
    state.model.active_classes = state.prev_model.active_classes = 17
    steps = [synthetic_batch(TRANSEG_BATCH, CROP, gen, dev, n_classes=17)
             for _ in range(TRANSEG_STEPS + 1)]
    state, _ = bacs_train(state, steps[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    bacs_losses, bacs_ms = [], []
    for b in steps[1:]:
        t0 = time.perf_counter()
        state, metrics = bacs_train(state, b)
        bacs_losses.append(float(metrics["loss"]))
        bacs_ms.append(1000 * (time.perf_counter() - t0))
    out["bacs_counts"] = c = counts()
    bacs_peak = torch.cuda.max_memory_allocated()
    assert all(np.isfinite(bacs_losses)), bacs_losses
    for key in ("k3f", "k3b", "k4f", "k4b"):
        assert c[key] == TRANSEG_STEPS, (key, c)
    assert c["train_abn"] == 3 * TRANSEG_ABN * TRANSEG_STEPS, c
    assert c["k5"] == TRANSEG_ABN * TRANSEG_STEPS, c  # the previous model
    assert c["k1f"] == c["k1b"] == c["k2"] == 0, c
    bacs_busy, parts = profile_by_kind(lambda: bacs_train(state, steps[1]),
                                       f"TranSeg bf16 BACS+ steps (batch {TRANSEG_BATCH})")
    for part, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
        log(f"[p] TranSeg BACS+ step by kind: {ms:.3f} ms ({ms / bacs_busy:.1%}) {part}")
    bacs_med = float(np.median(bacs_ms))
    log(f"[34] TranSeg task-1 BACS+ step (detector, batch {TRANSEG_BATCH} + replay 2 x "
        f"{TRANSEG_BATCH}, 17 of 21 tokens after the mean growth; end_task of task 0 over "
        f"{TRANSEG_FILL} x {TRANSEG_BATCH} images {t_end:.3f} s, buffer "
        f"{int(state.buffer.valid.sum())} valid): losses "
        f"{' '.join(f'{v:.4f}' for v in bacs_losses)}; median wall {bacs_med:.3f} ms, device "
        f"busy {bacs_busy:.3f} ms (idle share {1 - bacs_busy / bacs_med:.3f}), peak "
        f"{bacs_peak / 2**30:.3f} GiB; launches {c}")
    out["bacs"] = dict(wall=bacs_med, busy=bacs_busy, peak=bacs_peak / 2**30)
    del state
    torch.cuda.empty_cache()
    return out


def transeg_cli(seed: int) -> dict:
    """[35] ``bacs_tpu_torch.main.train`` in-process on
    ``conf/experiments/bacs_transformer_config`` (TranSeg, bacs_plus, the
    TransformerLearner with mean token growth, the detector, batch 12, bf16)
    with [24]'s synthetic source and the fused stem, no checkpoints: all 6
    tasks.  Checks the token growth at every boundary (the new rows the
    mean of the old, ``mask_norm`` 1 and 0, the model and the previous
    model at the task's class count) and returns the final mIoU, the
    Trainer and the launches over the run."""
    from unittest import mock

    from bacs_tpu_torch import main as cli
    from bacs_tpu_torch.config import load_config
    from bacs_tpu_torch.train import loop
    from bacs_tpu_torch.utils.logging import Logger

    config = load_config(*TRANSEG_CONFIG, TRANSEG_OVERRIDES + [f"training.seed={42 + seed}"])
    trainers, grown, metrics = [], [], []
    Trainer = loop.Trainer

    class Checked(Trainer):
        def fit(self):
            trainers.append(self)
            return super().fit()

        def _set_active_classes(self, task):
            super()._set_active_classes(task)
            n = task.nb_current_classes
            assert self.state.model.active_classes == n
            if task.task_id > 0:
                assert token_growth_ok(self.state.model, task), task.task_id
                assert self.state.prev_model.active_classes == n
                grown.append(task.task_id)

    reset_counts, counts = launch_counters()
    reset_counts()
    t0 = time.perf_counter()
    with mock.patch.object(loop, "Trainer", Checked), mock.patch.object(
            Logger, "log_metrics", lambda self, m: metrics.append(dict(m))):
        miou = cli.train(config, "cuda")
    wall = time.perf_counter() - t0
    tr = trainers[0]
    assert isinstance(tr.state.model, loop.TranSeg) and tr.n_tasks == N_TASKS
    assert grown == list(range(1, N_TASKS)), grown
    assert np.isfinite(miou), miou
    final = {k: v for m in metrics for k, v in m.items() if k.startswith("Final/")}
    assert final and all(np.isfinite(v) for v in final.values()), final
    return dict(miou=miou, trainer=tr, launches=counts(), wall=wall)


def report_transeg_cli(run: dict) -> None:
    """[35] log and hold the protocol run's launches."""
    c, tr = run["launches"], run["trainer"]
    log(f"[35] CLI train() on {'/'.join(TRANSEG_CONFIG)} {' '.join(TRANSEG_OVERRIDES)}: "
        f"final mIoU {run['miou']:.4f} in {run['wall']:.1f} s; the mean token growth and "
        f"the class counts held at tasks 1-5; launches {c}")
    for k, sec in enumerate(tr.task_seconds):
        log(f"[35] task {k}: " + ", ".join(f"{p} {v:.2f} s" for p, v in sec.items()))
    log(f"[35] Trainer.throughput {tr.throughput:.2f} img/s")
    for key in ("k1f", "k1b", "k2", "k3f", "k3b", "k4f", "k4b", "k5", "train_abn",
                "k12f", "k12b"):
        assert c[key] > 0, (key, c)
    assert c["k10"] == 0, c


# each row of the kernels line by the suffix of its name: its launch counters
TRANSEG_ROW_KEYS = {"(K5)": ("k5", "train_abn"), "(K10)": ("k10",),
                    "(K1 forward)": ("k1f",), "(K1 backward)": ("k1b",), "(K2)": ("k2",),
                    "(K3 forward)": ("k3f",), "(K3 backward)": ("k3b",),
                    "(K4 forward)": ("k4f",), "(K4 backward)": ("k4b",),
                    "(K6 forward)": ("k6f",), "(K6 backward)": ("k6b",),
                    "(K7 forward)": ("k7f",), "(K7 backward)": ("k7b",), "(K8)": ("k8",),
                    "(K9)": ("k9",), "(K12 forward)": ("k12f",),
                    "(K12 backward)": ("k12b",)}


def transeg_main(args) -> int:
    """``--transeg``: build, then phases [33]-[35] alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.abspath("build/triton"))
    from bacs_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    build.load_library()
    log(f"[1] build {time.perf_counter() - t0:.1f} s; nvidia-smi: {nvidia_smi()}")
    reset_counts, counts = launch_counters()
    t0 = time.perf_counter()
    transeg_step_card_vs_cpu(args.seed, dev)
    t33 = time.perf_counter() - t0
    transeg_full_width(args.seed, dev, reset_counts, counts)
    t34 = time.perf_counter() - t0 - t33
    report_transeg_cli(transeg_cli(args.seed))
    log(f"[time] [33] {t33:.1f} s, [34] {t34:.1f} s, [35] "
        f"{time.perf_counter() - t0 - t33 - t34:.1f} s")
    return 0


# ---------------------------------------------------------------- the upsample+loss family

# the device busy ms per step measured in the runs before K7's and K12's
# redesign (PERF.md section 5; NVIDIA H100 80GB HBM3, 700 W), printed
# beside this run's
EARLIER_BUSY_MS = {"CE step (phase [9])": "97.308-98.330",
                   "BACS step (phase [14])": "360.897-361.694",
                   "MiB step (phase [19])": "78.366-78.579",
                   "PLOP step (phase [19])": "103.729-104.212",
                   "fused stem on against off (phase [23])": "-0.28 to -2.16"}
# the kernel ms measured before each one's redesign (PERF.md section 6, the
# same card): K1-K8's before the family's templates, K2's, K7's, K9's, K10's
# and K12's on the first port's one-thread-per-element design (K2, K9 and
# K10: the last two full runs before their redesign); printed beside this
# run's
EARLIER_KERNEL_MS = {"k1f": "0.1872 / 0.1889", "k1b": "0.7412 / 0.7441",
                     "k2": "0.1173 / 0.1169",
                     "k10": "0.1780 / 0.1795", "k9": "0.2188 / 0.2228",
                     "k3f": "0.1914 / 0.1896 / 0.1900", "k3b": "0.7571 / 0.7505 / 0.7528",
                     "k4f": "0.1183 / 0.1166 / 0.1171", "k4b": "0.4846 / 0.4802 / 0.4811",
                     "k6f": "0.1389 / 0.1362", "k6b": "0.5439 / 0.5415",
                     "k7f": "0.2998 / 0.2986 / 0.2982", "k7b": "1.2424 / 1.2543 / 1.2415",
                     "k8": "0.4484 / 0.4464 / 0.4647",
                     "k12f": "0.1898 / 0.1897 / 0.1888", "k12b": "0.6373 / 0.6370 / 0.6368"}
# the kernels of the staged templates and their main-path shapes: K1 at the
# CE step, K2 at its eval step, K3 at the BACS main batch, K4 at its dark++
# replay batch, K6, K7 (the student; its teacher one channel fewer) and K8
# at the MiB and PLOP steps, K9 at PLOP's teacher, K10 at the served batch;
# and the fused stem's K12 at the CLI's batch (its conv output c)
FAMILY_SHAPES = {"k1": (BATCH, CROP // 16, CROP // 16, N_CLASSES),
                 "k2": (BATCH, CROP // 16, CROP // 16, N_CLASSES),
                 "k3": (BATCH, CROP // 16, CROP // 16, 17),
                 "k4": (12, CROP // 16, CROP // 16, 17),
                 "k6": (12, CROP // 16, CROP // 16, 17),
                 "k7": (12, CROP // 16, CROP // 16, 17),
                 "k8": (12, CROP // 16, CROP // 16, 17),
                 "k9": (12, CROP // 16, CROP // 16, OLD_CLASSES),
                 "k10": (BATCH, CROP // 16, CROP // 16, N_CLASSES),
                 "k12": (12, CROP // 2, CROP // 2, 64)}
# the symbols of the kernels whose registers and spills the build report
# prints (K7 is the templates' UkdTerm instance)
FAMILY_SYMBOLS = ("sums_kernel", "sums_reduce_kernel", "grad_bands_kernel",
                  "band_sum_kernel", "pixel_kernel", "conf_kernel",
                  "stem_pool_fwd_kernel", "stem_pool_grad_kernel")


def family_calls(dev, seed=0, shapes=None, out_hw=(CROP, CROP)) -> dict:
    """{key: call} of K1, K3, K4, K6, K7, K12 (forward and backward), K2,
    K8, K9 and K10 at ``shapes`` (default: the main path's; K2 also as
    ``k2t``, at the main path's only, on ``synthetic_batch``'s labels and
    ``trained_like_logits``, and as ``k2a`` at ADE's 150 classes), bf16,
    int32 labels
    with ~5 % ignored (a third background for K3 and K6; K9's in [0, C],
    C the new class), K3's max_seen uniform, K4's dark++ weights, K7's
    teacher of one channel fewer and MiB's scale, K8's g one random value
    per image, K9's thresholds 0.5 and max entropy log(C + 1), K12 on the
    stem's inputs of ``stem_inputs`` (``out_hw`` does not apply); each call
    returns the kernel's output tensors.  Uses only the wrappers' public
    signatures, which the first port's kernels share."""
    from bacs_tpu_torch.ops.stem_pool import (
        backward_vectors, forward_vectors, stem_pool_fwd, stem_pool_grad)
    from bacs_tpu_torch.ops.upsample_argmax import upsampled_argmax_conf
    from bacs_tpu_torch.ops.upsample_ce import (
        bacs_dsem, bacs_sum, ce_dsem, ce_dsem_per_image, ce_sums_per_image, uce_dsem,
        uce_sums, ukd_dsem, ukd_sum, wce_dsem, wce_sums)
    from bacs_tpu_torch.ops.upsample_confusion import upsampled_confusion
    from bacs_tpu_torch.ops.upsample_pseudo import plop_pseudo_labels

    shapes = shapes or FAMILY_SHAPES
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    ins = {}
    for key, shape in shapes.items():
        if key == "k12":
            continue
        n, c = shape[0], shape[-1]
        sem = (torch.randn(shape, generator=g, device=dev) * 3).to(torch.bfloat16)
        lab = seeded_labels(n, out_hw, c + 1 if key == "k9" else c, dev, seed)
        if key in ("k3", "k6"):
            bg = torch.rand(lab.shape, generator=g, device=dev) < 0.3
            lab = torch.where(bg & (lab != 255), torch.zeros_like(lab), lab)
        ins[key] = (sem, lab, c)
    hw = tuple(out_hw)
    sem1, lab1, _ = ins["k1"]
    sem3, lab3, c3 = ins["k3"]
    sem4, lab4, c4 = ins["k4"]
    sem6, lab6, c6 = ins["k6"]
    sem8, lab8, _ = ins["k8"]
    sem7 = ins["k7"][0]
    old7 = (torch.randn((*sem7.shape[:3], sem7.shape[-1] - 1), generator=g, device=dev)
            * 3).to(torch.bfloat16)
    g7 = torch.tensor(-1.0 / (sem7.shape[0] * hw[0] * hw[1]), device=dev)
    c12, scale12, bias12, dp12 = stem_inputs(shapes["k12"], torch.bfloat16, dev, seed + 12)
    with torch.no_grad():
        mean12, _, inv12, vec12 = forward_vectors(c12, scale12, bias12)
        p12 = stem_pool_fwd(c12, vec12, 0.01)
        dap12, vec7_12, _, _ = backward_vectors(c12, p12, dp12, scale12, bias12, mean12,
                                                inv12, vec12, 0.01)
    ms = torch.rand(lab3.shape, generator=g, device=dev)
    w4 = beta_weights(c4, dev)
    g1 = torch.tensor(1.0 / lab1.numel(), device=dev)
    g3 = torch.tensor(1.0 / lab3.numel(), device=dev)
    g4 = torch.tensor(1.0 / lab4.numel(), device=dev)
    g6 = torch.tensor(1.0 / lab6.numel(), device=dev)
    g8 = (torch.rand(sem8.shape[0], generator=g, device=dev) / lab8.numel()).contiguous()
    sem9, lab9, c9 = ins["k9"]
    thr9 = torch.full((max(N_CLASSES, c9),), 0.5, device=dev)
    me9 = torch.tensor(float(np.log(c9 + 1)), device=dev)
    sem10 = ins["k10"][0]
    sem2, lab2, c2 = ins["k2"]
    extra = {}
    if shapes is FAMILY_SHAPES:
        lab2t = synthetic_batch(shapes["k2"][0], out_hw[0], g, dev, c2)["label"]
        sem2t = trained_like_logits(lab2t, c2, g)
        extra["k2t"] = lambda: upsampled_confusion(sem2t, lab2t, hw, c2)
        sem2a = (torch.randn((*shapes["k2"][:3], ADE_CLASSES), generator=g, device=dev)
                 * 3).to(torch.bfloat16)
        lab2a = seeded_labels(shapes["k2"][0], out_hw, ADE_CLASSES, dev, seed)
        extra["k2a"] = lambda: upsampled_confusion(sem2a, lab2a, hw, ADE_CLASSES)
    return {
        "k1f": lambda: ce_sums_per_image(sem1, lab1, hw),
        "k1b": lambda: ce_dsem(sem1, lab1, hw, g1),
        "k3f": lambda: bacs_sum(sem3, lab3, ms, hw, c3 - 1),
        "k3b": lambda: bacs_dsem(sem3, lab3, ms, hw, g3, c3 - 1),
        "k4f": lambda: wce_sums(sem4, lab4, w4, hw),
        "k4b": lambda: wce_dsem(sem4, lab4, w4, hw, g4),
        "k6f": lambda: uce_sums(sem6, lab6, hw, c6 - 1),
        "k6b": lambda: uce_dsem(sem6, lab6, hw, g6, c6 - 1),
        "k7f": lambda: ukd_sum(sem7, old7, hw),
        "k7b": lambda: ukd_dsem(sem7, old7, hw, g7),
        "k8": lambda: ce_dsem_per_image(sem8, lab8, hw, g8),
        "k9": lambda: plop_pseudo_labels(sem9, lab9, thr9, hw, me9),
        "k10": lambda: upsampled_argmax_conf(sem10, hw),
        "k2": lambda: upsampled_confusion(sem2, lab2, hw, c2),
        "k12f": lambda: stem_pool_fwd(c12, vec12, 0.01),
        "k12b": lambda: stem_pool_grad(c12, dap12, vec7_12, 0.01),
        **extra,
    }


def check_repeatable(calls: dict) -> None:
    """Each call twice on the same inputs: bit-equal outputs (no float
    atomics, sums in a fixed order)."""
    for key, fn in calls.items():
        a, b = fn(), fn()
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b)), f"{key} differs between launches"


def library_pair_ms(sem, labels, out_hw, weight=None) -> tuple:
    """(forward ms, backward ms) of the unfused PyTorch pair that computes
    K1 (or K4 with ``weight``): ``F.interpolate(bilinear,
    align_corners=False)`` of the NCHW view of sem, then
    ``F.cross_entropy(reduction="sum", ignore_index=255)``, host-launched
    CUDA events; backward = forward + autograd backward - forward.  A
    yardstick only: the port never calls it."""
    import torch.nn.functional as F

    x = sem.permute(0, 3, 1, 2).detach().requires_grad_()
    lab = labels.long()
    weight = None if weight is None else weight.to(x.dtype)  # cross_entropy's rule

    def loss():
        up = F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False)
        return F.cross_entropy(up, lab, weight=weight, ignore_index=255, reduction="sum")

    with torch.no_grad():
        fwd = time_ms(loss, iters=10)
    both = time_ms(lambda: loss().backward(), iters=10)
    return fwd, both - fwd


def library_trio_ms(sem, labels, out_hw, num_classes) -> float:
    """ms of the unfused PyTorch trio that computes K2: ``F.interpolate``
    (bilinear, align_corners=False) of the NCHW view of sem, ``argmax`` over
    the channels, then ``torch.bincount`` of t * nc + pred over the pixels
    whose label is in [0, nc) (the others in a bin past the matrix);
    host-launched CUDA events.  A yardstick only: the port never calls it."""
    import torch.nn.functional as F

    x = sem.permute(0, 3, 1, 2)
    nc = num_classes

    def trio():
        pred = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                             align_corners=False).argmax(1).clamp(max=nc - 1)
        t = labels.long()
        idx = torch.where((t >= 0) & (t < nc), t * nc + pred, nc * nc)
        return torch.bincount(idx.flatten(), minlength=nc * nc + 1)[:nc * nc]

    with torch.no_grad():
        return time_ms(trio, iters=10)


def trained_like_logits(labels, c, gen, margin=6.0):
    """bf16 logits [n, H / 16, W / 16, c] whose argmax follows the labels'
    blocks, as a trained network's does: unit noise plus ``margin`` on the
    class of the label at each cell's centre (0 where that is dropped).  On
    ``synthetic_batch``'s labels most warps of 32 neighbouring pixels that
    are all kept then fill one bin of the confusion matrix."""
    n, H, W = labels.shape
    centre = labels[:, 8::16, 8::16].long()
    centre = torch.where((centre >= 0) & (centre < c), centre, 0)
    sem = torch.randn((n, H // 16, W // 16, c), generator=gen, device=labels.device)
    sem += margin * torch.nn.functional.one_hot(centre, c)
    return sem.to(torch.bfloat16)


def one_bin_warps(sem, labels, out_hw, num_classes) -> float:
    """The share of warps of K2's tile loop (32 neighbouring pixels of an
    output row, whole rows; W a multiple of 32) whose 32 pixels are all
    kept and fill one bin: the warps whose 32 increments meet on one
    shared-memory address."""
    from bacs_tpu_torch.ops.upsample_ce import upsample_plain

    nc = num_classes
    pred = upsample_plain(sem, out_hw).argmax(-1).clamp(max=nc - 1)
    t = labels.long()
    key = torch.where((t >= 0) & (t < nc), t * nc + pred, -1).reshape(-1, 32)
    return float(((key == key[:, :1]) & (key >= 0)).all(-1).float().mean())


def ptxas_report(log_text: str) -> list:
    """[(kernel, registers, spill stores, spill loads)] of the family's new
    kernels from ``nvcc -Xptxas -v`` output, names demangled where
    ``c++filt`` is on the path."""
    import re
    import shutil

    rows, name = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            spills = None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and any(s in name for s in FAMILY_SYMBOLS):
            rows.append([name, int(m.group(1)), *(spills or (None, None))])
            name = None
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(out) == len(rows):
            for r, d in zip(rows, out):
                r[0] = d.replace("(anonymous namespace)::", "")
    return [tuple(r) for r in rows]


def build_and_report(build) -> None:
    """Build the CUDA kernels (``nvcc -Xptxas -v``) and load them; print
    each file's compile time and the registers and spills of the family's
    new kernels at the main path's types (bf16 logits, int32 labels)."""
    build_log = io.StringIO()
    with contextlib.redirect_stdout(build_log):  # each file's ptxas report and time
        build.build(verbose=True)
    build.load_library()
    for line in build_log.getvalue().splitlines():
        if line.startswith("nvcc "):
            log(f"[1] {line}")
    report = ptxas_report(build_log.getvalue())
    main_path = [r for r in report if "__nv_bfloat16" in r[0] and "long" not in r[0]
                 and "sums_reduce" not in r[0]]
    for name, regs, spill_st, spill_ld in main_path or report:
        log(f"[1] ptxas: {name}: {regs} registers, spill stores {spill_st} B, "
            f"spill loads {spill_ld} B")
    if not report:
        log("[1] ptxas: no report (the library was built before this run)")


def family_times_main(args) -> int:
    """``--family-times``: build, then time the family's kernels at the main
    path's shapes and print them as one JSON line (with ``--package-root``
    the port of another checkout, e.g. the parent commit, so that two
    versions are timed in one call)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))
    from bacs_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    build_and_report(build)
    with sm_clock("the family's timings"):
        times = {k: device_ms(fn) for k, fn in family_calls(dev, args.seed).items()}
    print(json.dumps({"family_ms": times, "package": os.path.dirname(build.PKG_DIR),
                      "device": torch.cuda.get_device_name(0), "smi": nvidia_smi(),
                      "sm_clock": nvidia_smi("clocks.sm,clocks.max.sm")}), flush=True)
    return 0


# ---------------------------------------------------------------- fused stem (K12)

# the stem's conv output at the CLI's batch (der_15_1_bg.yaml) and at phase
# [9]'s; two small odd-sized cases (H/2 odd, W = 2)
STEM_MAIN = (12, 256, 256, 64)
STEM_CASES = [(BATCH, 256, 256, 64), STEM_MAIN, (3, 6, 2, 5), (2, 10, 2, 64)]
STEM_TIES = (4, 64, 64, 64)  # inputs on 3 levels: most windows repeat their max
ABN_PER_FUSED_STEM_FORWARD = ABN_PER_FORWARD - 1  # the stem's ABN is K12's


def ce_step_card_vs_cpu(label, cfg, params, stats, dev, seed, fused_stem=False) -> None:
    """[8] (and [22] with ``fused_stem``): one f32 CE train step of RN101 at 4
    x 128^2 on the card and on the CPU (TF32 off), with identity and with
    the configured leaky activations, held by ``hold_step``.  With the fused
    stem the card's step launches K12 once each way."""
    from bacs_tpu_torch.ops.stem_pool import stem_pool_fwd, stem_pool_grad

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = synthetic_batch(4, 128, torch.Generator().manual_seed(seed), "cpu")
    for activation in ("identity", "leaky"):
        runs = {}
        for device in (dev, torch.device("cpu")):
            state = train_state(cfg, params, stats, torch.float32, device,
                                smooth=activation == "identity", fused_stem=fused_stem)
            p0 = {k: p.detach().cpu().clone() for k, p in state.model.named_parameters()}
            train_step, _, put_batch = ce_steps(device)
            k12 = stem_pool_fwd.launches, stem_pool_grad.launches
            state, metrics = train_step(state, put_batch(small))
            runs[device.type] = (float(metrics["loss"]), *grads_and_stats(state.model))
            if device.type == "cuda":
                launched = (stem_pool_fwd.launches - k12[0], stem_pool_grad.launches - k12[1])
                assert launched == ((1, 1) if fused_stem else (0, 0)), launched
            del state
        hold_step(label, activation, runs["cuda"], runs["cpu"], p0,
                  "; K12 launched once each way on the card" if fused_stem else "")
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def stem_step_compare(cfg, params, stats, dev, seed, reset_counts, counts) -> dict:
    """[23] The bf16 512^2 CE train step at batch 16 with the fused stem on
    against phase [9]'s configuration (off), on the same synthetic batches,
    timed in turns (off, on, on, off; 9 steps each after 2 warm-up):
    median wall, peak memory, launches per step (on: 1 K12 each way and
    106 train-ABN applies; off: none and 107) and a two-step profile each,
    with the stem's kernels' share (on: K12; off: the max-pool's)."""
    train_step, _, _ = ce_steps(dev)
    states = {name: train_state(cfg, params, stats, torch.bfloat16, dev,
                                fused_stem=name == "on") for name in ("off", "on")}
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    batches = [synthetic_batch(BATCH, CROP, gen, dev) for _ in range(TRAIN_STEPS // 2)]
    for state in states.values():
        for b in batches[:WARMUP_STEPS]:
            float(train_step(state, b)[1]["loss"])
    walls, peaks, got = {"off": [], "on": []}, {}, {}
    for name in ("off", "on", "on", "off"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        for b in batches:
            t0 = time.perf_counter()
            _, metrics = train_step(states[name], b)
            assert np.isfinite(float(metrics["loss"]))  # a host read: synchronises
            walls[name].append(1000 * (time.perf_counter() - t0))
        peaks[name] = max(peaks.get(name, 0), torch.cuda.max_memory_allocated())
        for k, v in counts().items():
            got.setdefault(name, {})[k] = got.get(name, {}).get(k, 0) + v
    out = {}
    for name, state in states.items():
        steps = len(walls[name])
        per_step = {k: v / steps for k, v in got[name].items()}
        on = name == "on"
        assert per_step["k12f"] == per_step["k12b"] == (1 if on else 0), per_step
        assert per_step["train_abn"] == (ABN_PER_FUSED_STEM_FORWARD if on else ABN_PER_FORWARD)
        assert per_step["k1f"] == per_step["k1b"] == 1, per_step
        events, prof = device_kernels(lambda: train_step(state, batches[0]))
        busy = sum(e.self_device_time_total for e in events) / 1000 / 2
        stem = sum(e.self_device_time_total for e in events
                   if ("stem_pool" if on else "max_pool") in e.key) / 1000 / 2
        med = float(np.median(walls[name]))
        log(f"[23] bf16 CE train step, batch {BATCH}, {CROP}^2, fused stem {name}: median "
            f"{med:.3f} ms ({BATCH * 1000 / med:.2f} img/s) over {steps} steps in two turns; "
            f"peak memory {peaks[name] / 2**30:.3f} GiB (both states resident); device busy "
            f"{busy:.3f} ms, idle share {1 - busy / med:.3f}; {'K12' if on else 'max-pool'} "
            f"kernels {stem:.3f} ms ({stem / busy:.1%} of busy); launches per step {per_step}")
        out[name] = dict(med=med, busy=busy, stem=stem, peak=peaks[name], counts=got[name])
    del states
    torch.cuda.empty_cache()
    return out


def stem_inputs(shape, dtype, device, seed=0, levels=None):
    """(c, scale, bias, dp) of the fused stem, seeded; ``levels`` puts every
    input on a few levels (ties)."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = torch.randn(shape, generator=g, device=device) * 2 + 0.3
    if levels:
        c = torch.round(c * levels / 4) * (4.0 / levels)
    ch = shape[-1]
    scale = torch.rand(ch, generator=g, device=device) + 0.5
    scale[::3] *= -1  # negative scales flip the order before the activation
    bias = torch.randn(ch, generator=g, device=device) * 0.1
    n, h, w, _ = shape
    dp = torch.randn((n, h // 2, w // 2, ch), generator=g, device=device).to(dtype)
    return c.to(dtype).contiguous(), scale, bias, dp


def near_tie_cells(c, vec, slope):
    """[n, H, W, C] bool: the input cells of every window whose top two
    candidates (f32 y) lie within one bf16 ulp of the max, where the
    kernel's and the plain version's argmax may part."""
    from bacs_tpu_torch.ops.stem_pool import _activate

    n, h, w, ch = c.shape
    y = torch.nn.functional.pad(_activate(c, vec[0], vec[1], slope), (0, 0, 1, 1, 1, 1),
                                value=-1e30)
    planes = torch.stack([y[:, ky:ky + h:2, kx:kx + w:2, :] for ky in range(3)
                          for kx in range(3)])
    top2 = planes.topk(2, dim=0).values
    ulp = top2[0].abs() * 2.0 ** -7
    near = (top2[0] - top2[1]) <= ulp
    cells = torch.zeros((n, h + 2, w + 2, ch), dtype=torch.bool, device=c.device)
    for ky in range(3):
        for kx in range(3):
            cells[:, ky:ky + h:2, kx:kx + w:2, :] |= near
    return cells[:, 1:h + 1, 1:w + 1, :]


def check_stem(shape, dtype, device, seed=0, levels=None) -> dict:
    """[21] K12 forward and backward against their plain versions on the same
    inputs (the vectors of ``forward_vectors`` / ``backward_vectors``).  f32:
    values within rtol 2e-3 and gradients within 5e-2 of their largest
    (``scripts/check_kernels_tpu.py:247-248``); bf16: values exact, gradients
    exact outside windows with a near tie.  Returns the errors and whether
    both came out bit-equal."""
    from bacs_tpu_torch.ops.stem_pool import (
        backward_vectors, forward_vectors, stem_pool_fwd, stem_pool_grad,
        stem_pool_grad_plain, stem_pool_plain)

    slope = 0.01
    c, scale, bias, dp = stem_inputs(shape, dtype, device, seed, levels)
    with torch.no_grad():
        mean, _, inv, vec = forward_vectors(c, scale, bias)
        p, p_ref = stem_pool_fwd(c, vec, slope), stem_pool_plain(c, vec, slope)
        dap, vec7, _, _ = backward_vectors(c, p_ref, dp, scale, bias, mean, inv, vec, slope)
        dc, dc_ref = stem_pool_grad(c, dap, vec7, slope), stem_pool_grad_plain(c, dap, vec7, slope)
    torch.cuda.synchronize()
    val_err = float((p.float() - p_ref.float()).abs().max())
    diff = (dc.float() - dc_ref.float()).abs()
    grad_err = float(diff.max())
    excluded = 0
    if dtype == torch.float32:
        assert val_err <= 2e-3 * float(p_ref.abs().max()), (shape, val_err)
        assert grad_err <= 5e-2 * float(dc_ref.abs().max()), (shape, grad_err)
    else:
        assert val_err == 0.0, (shape, val_err)
        near = near_tie_cells(c, vec, slope)
        excluded = int(near.sum())
        assert not bool((diff[~near] > 0).any()), (shape, grad_err)
    return {"val_abs": val_err, "grad_abs": grad_err, "excluded": excluded,
            "bit_equal": val_err == 0.0 and grad_err == 0.0}


def stem_raises(device) -> None:
    """[21] CUDA tensors the kernel does not take raise: f16, odd H, a
    non-contiguous layout; none falls back to the plain version."""
    from bacs_tpu_torch.ops.stem_pool import stem_pool_fwd

    vec = torch.zeros((2, 8), device=device)
    for c, err in ((torch.zeros((1, 4, 4, 8), dtype=torch.float16, device=device), TypeError),
                   (torch.zeros((1, 5, 4, 8), device=device), ValueError),
                   (torch.zeros((1, 8, 4, 4), device=device).permute(0, 2, 3, 1), ValueError)):
        try:
            stem_pool_fwd(c, vec, 0.01)
        except err:
            continue
        raise AssertionError(f"K12 took {c.dtype} {tuple(c.shape)}")


def stem_bound(c, kernel: str):
    """K12's bound on these inputs: bytes (c read, p written; backward c and
    dap read, dc written), the operations (per input cell the affine and
    leaky, 4; per window 9 compares; the backward adds the BN backward, 5
    per cell) far below the f32 rate."""
    n, h, w, ch = c.shape
    cells, wins, e = c.numel(), n * (h // 2) * (w // 2) * ch, c.element_size()
    if kernel == "k12f":
        return bound((cells + wins) * e, 4 * cells + 9 * wins)
    return bound((2 * cells + wins) * e, 9 * cells + 9 * wins)


def stem_kernel_times(dev, shape=STEM_MAIN) -> dict:
    """[t] K12 at ``shape`` in bf16: the kernels alone and their plain
    versions (CUDA-graph replay), the whole fused ABN + pool autograd pass
    and the unfused pair the port runs with fused_stem off (K5's
    ``fused_abn`` apply then ``F.max_pool2d``, and their autograd backward;
    host-launched CUDA events); backward = forward + backward - forward."""
    import torch.nn.functional as F

    from bacs_tpu_torch.ops.abn_core import fused_abn
    from bacs_tpu_torch.ops.stem_pool import (
        backward_vectors, forward_vectors, fused_abn_pool, stem_pool_fwd, stem_pool_grad,
        stem_pool_grad_plain, stem_pool_plain)

    c, scale, bias, dp = stem_inputs(shape, torch.bfloat16, dev, seed=5)
    with torch.no_grad():
        mean, _, inv, vec = forward_vectors(c, scale, bias)
        p = stem_pool_fwd(c, vec, 0.01)
        dap, vec7, _, _ = backward_vectors(c, p, dp, scale, bias, mean, inv, vec, 0.01)
    scale.requires_grad_()
    bias.requires_grad_()
    x = c.clone().requires_grad_()

    def unfused():
        y, _, _ = fused_abn(x, scale, bias)
        return F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1)

    def fused():
        return fused_abn_pool(x, scale, bias)[0]

    def fwd_bwd(fn, g):
        return lambda: fn().backward(g)

    with torch.no_grad():
        fwd = {"unfused": time_ms(unfused, iters=10), "fused": time_ms(fused, iters=10)}
    both = {"unfused": time_ms(fwd_bwd(unfused, dp.permute(0, 3, 1, 2)), iters=10),
            "fused": time_ms(fwd_bwd(fused, dp), iters=10)}
    out = {
        "k12f": (device_ms(lambda: stem_pool_fwd(c, vec, 0.01)),
                 device_ms(lambda: stem_pool_plain(c, vec, 0.01)),
                 fwd["unfused"], fwd["fused"]),
        "k12b": (device_ms(lambda: stem_pool_grad(c, dap, vec7, 0.01)),
                 device_ms(lambda: stem_pool_grad_plain(c, dap, vec7, 0.01)),
                 both["unfused"] - fwd["unfused"], both["fused"] - fwd["fused"]),
    }
    for key, label in (("k12f", "forward"), ("k12b", "backward")):
        bnd = stem_bound(c, key)
        kernel, plain, pair, whole = out[key]
        log(f"[t] K12 {label} {tuple(shape)} bf16: kernel {kernel:.4f} ms (before: "
            f"{EARLIER_KERNEL_MS[key]}), plain "
            f"{plain:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); the whole fused ABN + pool "
            f"{label} {whole:.4f} ms against the unfused pair fused_abn (K5 apply) + "
            f"max_pool2d {pair:.4f} ms (host-launched, CUDA events)")
        out[key] = (kernel, plain, pair, whole, bnd)
    return out


# ---------------------------------------------------------------- the trainer

# [24] the paper's BACS+ recipe through the port's CLI: conf/bacs with
# training/der_15_1_bg.yaml (batch 12, the detector, 300 slots, alpha 0.8,
# beta 0.5), the fused stem, on the synthetic source at VOC's widths; one
# step per new class, one epoch per task.  400 / 48 images give every task
# train and validation images (tasks 1-5: 31-37 and 4-8), and task 0 16
# steps over 223 images, so the reservoir fills.
CLI_OVERRIDES = ["training=der_15_1_bg", "loss=bacs_plus_bg", "+network.fused_stem=true",
                 "dataset._target_=dataloaders.SyntheticDataModule",
                 "+dataset.dataset.n_train=400", "+dataset.dataset.n_val=48",
                 "+training.steps_per_class=1", "training.epochs=1"]
CLI_CKPT = "build/chip_smoke_ckpt"


def cli_protocol(seed: int) -> dict:
    """[24] ``bacs_tpu_torch.main.train`` in-process on the full-width config:
    all 6 tasks, stopped after task 1's first mid-task checkpoint and resumed
    from it.  Counts K12 per train step (one each way per train-mode network
    pass: 1 at task 0, 3 at later tasks), records the logged metric keys,
    profiles the last task (device busy against its wall) and returns the
    counts, the final mIoU, the per-task seconds and the throughput."""
    import shutil
    from unittest import mock

    from bacs_tpu_torch import main as cli
    from bacs_tpu_torch.config import load_config
    from bacs_tpu_torch.ops.stem_pool import stem_pool_fwd, stem_pool_grad
    from bacs_tpu_torch.train import loop
    from bacs_tpu_torch.utils import checkpoint
    from bacs_tpu_torch.utils.logging import Logger

    ckpt = os.path.abspath(CLI_CKPT)
    shutil.rmtree(ckpt, ignore_errors=True)
    config = load_config("conf/bacs", "bacs_plus_config",
                         CLI_OVERRIDES + [f"training.seed={42 + seed}",
                                          f"training.ckpt_dir={ckpt}"])
    metrics, per_step, trainers, saves = [], [], [], []
    make_steps, Trainer = loop.make_steps, loop.Trainer

    def counting_steps(ctx, *a, **k):
        train_step, eval_step, put_batch = make_steps(ctx, *a, **k)

        def step(state, batch):
            f0, b0 = stem_pool_fwd.launches, stem_pool_grad.launches
            state, out = train_step(state, batch)
            per_step.append((ctx.task.task_id, stem_pool_fwd.launches - f0,
                             stem_pool_grad.launches - b0, float(out["loss"])))
            return state, out
        return step, eval_step, put_batch

    class Recorded(Trainer):
        def __init__(self, config, datamodule=None, device="cuda"):
            # the resumed run reads the first run's data (the same images,
            # made again from the same seeds otherwise)
            super().__init__(config, datamodule or (trainers[0].datamodule if trainers
                                                    else None), device)

        def fit(self):
            trainers.append(self)
            return super().fit()

        def _run_task(self, task_id):
            if task_id < self.n_tasks - 1:
                return super()._run_task(task_id)
            events, _ = device_kernels(lambda: results.append(super(Recorded, self)
                                                              ._run_task(task_id)),
                                       steps=1, warm=False)
            busy = sum(e.self_device_time_total for e in events) / 1e6
            self.last_task_busy = (busy, self.task_seconds[-1]["wall"])
            return results.pop()

    results = []
    fwd0, bwd0 = stem_pool_fwd.launches, stem_pool_grad.launches
    with contextlib.ExitStack() as patched:
        for obj, name, value in ((loop, "make_steps", counting_steps), (loop, "Trainer", Recorded),
                                 (Logger, "log_metrics", lambda self, m: metrics.append(dict(m)))):
            patched.enter_context(mock.patch.object(obj, name, value))
        t0 = time.perf_counter()
        try:
            with checkpoint.resume_check_saves(stop_task=1, record=saves):
                cli.train(config, "cuda")
            raise AssertionError("the first run was not stopped")
        except checkpoint.Interrupted as e:
            t_first = time.perf_counter() - t0
            log(f"[24] first run stopped after task 1's mid-task checkpoint {e} at "
                f"{t_first:.1f} s")
        t0 = time.perf_counter()
        with checkpoint.resume_check_saves(record=saves):
            miou = cli.train(config, "cuda")
        t_resumed = time.perf_counter() - t0
    launches = {"k12f": stem_pool_fwd.launches - fwd0, "k12b": stem_pool_grad.launches - bwd0}
    first, resumed = trainers
    shutil.rmtree(ckpt, ignore_errors=True)
    return dict(miou=miou, metrics=metrics, per_step=per_step, saves=saves,
                launches=launches, first=first, resumed=resumed, t_first=t_first,
                t_resumed=t_resumed)


def report_cli(run: dict) -> None:
    """[24] log and hold the protocol run."""
    n_tasks = run["resumed"].n_tasks
    keys = {k for m in run["metrics"] for k in m}
    want = {f"test.{d}/Task {t}/{k}" for t in range(n_tasks) for d in range(t + 1)
            for k in ("mIoU", "IoU-Old", "loss", "Accuracy")}
    want |= {f"test.{d}_aux_bg/{k}" for d in range(n_tasks)
             for k in ("mIoU", "IoU-bg", "bg_prob_mean", "fg_prob_mean")}
    want |= {f"Final/test.{d}/{k}" for d in range(n_tasks) for k in ("mIoU", "Avg-IoU")}
    missing = want - keys
    assert not missing, sorted(missing)[:10]
    assert n_tasks == N_TASKS and np.isfinite(run["miou"]), run["miou"]
    for task_id, f, b, _ in run["per_step"]:
        passes = 1 if task_id == 0 else 3  # main; main, alpha and beta replay
        assert f == b == passes, (task_id, f, b)
    non_finite = sum(not np.isfinite(loss) for *_, loss in run["per_step"])
    final = {k: v for m in run["metrics"] for k, v in m.items() if k.startswith("Final/")}
    log(f"[24] CLI train() on conf/bacs/bacs_plus_config {' '.join(CLI_OVERRIDES)}: "
        f"final mIoU {run['miou']:.4f}; first run {run['t_first']:.1f} s (tasks 0-1, "
        f"stopped), resumed run {run['t_resumed']:.1f} s (tasks 1-5); {len(keys)} metric keys, "
        f"all expected present")
    log(f"[24] Final: {json.dumps({k: round(v, 4) for k, v in sorted(final.items())})}")
    log(f"[24] train steps (task, K12 forward, K12 backward, loss): {run['per_step']}; "
        f"{non_finite} non-finite losses; K12 launches over both runs (the boundary "
        f"passes' train-mode forwards included) {run['launches']}")
    for name in ("first", "resumed"):
        tr = run[name]
        for k, sec in enumerate(tr.task_seconds):
            log(f"[24] {name} run, task {k + (0 if name == 'first' else 1)}: "
                + ", ".join(f"{p} {v:.2f} s" for p, v in sec.items()))
        log(f"[24] {name} run: Trainer.throughput {tr.throughput:.2f} img/s (steps after "
            f"each task's second; 0 where no task trains more than two)")
    busy, wall = run["resumed"].last_task_busy
    log(f"[24] last task (5) profiled: device busy {busy:.3f} s of its {wall:.3f} s wall "
        f"(under the profiler): device idle share {1 - busy / wall:.3f}")
    for task_id, step, sec, size in run["saves"]:
        log(f"[24] checkpoint step_{task_id}/{step}: {size / 2**30:.3f} GiB in {sec:.2f} s")


# ---------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--family-times", action="store_true",
                    help="only build and time the upsample+loss family's kernels")
    ap.add_argument("--bacs-busy", action="store_true",
                    help="only build and time the task-1 BACS step's device busy time")
    ap.add_argument("--package-root", default=None,
                    help="with --family-times or --bacs-busy: the checkout whose port "
                         "to time")
    ap.add_argument("--transeg", action="store_true",
                    help="only build and run the TranSeg phases [33]-[35]")
    args = ap.parse_args()
    if args.transeg:
        return transeg_main(args)
    if args.family_times:
        return family_times_main(args)
    if args.bacs_busy:
        return bacs_busy_main(args)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.abspath("build/triton"))
    from bacs_tpu_torch.kernels import build
    from bacs_tpu_torch.ops.abn_core import abn_eval_plain, fused_abn_eval
    from bacs_tpu_torch.ops.upsample_argmax import upsampled_argmax_conf

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = nvidia_smi()
    t_main = time.perf_counter()

    # 1. environment and build
    log(f"[1] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    log(f"[1] nvidia-smi: {smi}")
    t0 = time.perf_counter()
    build_and_report(build)
    t_nvcc = time.perf_counter() - t0
    for dt in (torch.float32, torch.bfloat16):  # first Triton compiles
        check_abn((4, 8, 8, 64), 0.01, dt, dev)
    log(f"[1] build: nvcc {t_nvcc:.2f} s, nvcc + Triton "
        f"{time.perf_counter() - t0:.2f} s")

    # 2. K5 against its plain version
    k5_err = 0.0
    for shape in K5_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            for slope in (0.01, 1.0, 0.0):
                e = check_abn(shape, slope, dt, dev)
                k5_err = max(k5_err, e)
            log(f"[2] K5 {shape} {str(dt)[6:]}: ok, max abs err {e:.3g} "
                "(slopes 0.01, 1, 0)")

    # 3. K10 against its plain version
    k10_err = 0.0
    for shape, out_hw in K10_CASES:
        for dt in (torch.float32, torch.bfloat16):
            e = check_argmax(shape, out_hw, dt, dev)
            k10_err = max(k10_err, e)
            log(f"[3] K10 {shape}->{out_hw} {str(dt)[6:]}: ok, conf max abs "
                f"err {e:.3g}")
    for c in CHUNK_CHANNELS:
        for levels in (False, True):
            e = check_argmax((2, 8, 8, c), (128, 128), torch.bfloat16, dev, levels=levels)
            k10_err = max(k10_err, e)
        log(f"[3] K10 (2, 8, 8, {c})->(128, 128) bfloat16: ok, preds equal at every "
            f"exact tie of integer logits, conf max abs err {e:.3g}")

    # 4. end-to-end f32, card (kernels) against CPU (plain versions)
    cfg = network_cfg()
    params, stats = seeded_variables(cfg, args.seed)
    rs = np.random.RandomState(args.seed)
    img1 = rs.randint(0, 256, (1, CROP, CROP, 3)).astype(np.uint8)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    p_gpu32 = make_predictor(cfg, params, stats, torch.float32, dev)
    p_cpu32 = make_predictor(cfg, params, stats, torch.float32, "cpu")
    g_pred, g_conf = p_gpu32.predict(img1)
    c_pred, c_conf = p_cpu32.predict(img1)
    sem_g, sem_c = sem_logits(p_gpu32, img1), sem_logits(p_cpu32, img1)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    rel = float((sem_g - sem_c).abs().max() / sem_c.abs().max())
    agree = float((g_pred == c_pred).mean())
    conf_err = float(np.abs(g_conf.astype(np.float32) - c_conf.astype(np.float32)).max())
    log(f"[4] f32 card vs CPU, RN101 {CROP}^2 b1: preds agree {agree:.6f}, conf "
        f"max abs err {conf_err:.3g}, sem_logits max err / max |sem| {rel:.3g} "
        f"(max |sem| {float(sem_c.abs().max()):.4g}), classes used "
        f"{len(np.unique(c_pred))}")
    assert agree >= 0.999, agree
    assert conf_err <= 2e-3, conf_err
    del p_cpu32, p_gpu32
    torch.cuda.empty_cache()

    # 5. bf16 serving on the card, launches counted
    p16 = make_predictor(cfg, params, stats, torch.bfloat16, dev)
    batches = [rs.randint(0, 256, (BATCH, CROP, CROP, 3)).astype(np.uint8)
               for _ in range(8)]
    singles = [rs.randint(0, 256, (1, CROP, CROP, 3)).astype(np.uint8)
               for _ in range(20)]
    for _ in p16.predict_many(batches[:2]):  # warm-up
        pass
    p16.predict(singles[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_abn_eval.launches = 0
    upsampled_argmax_conf.launches = 0
    t0 = time.perf_counter()
    outs = list(p16.predict_many(batches))
    t_many = time.perf_counter() - t0
    single_outs, lat = [], []
    for s in singles:
        t0 = time.perf_counter()
        single_outs.append(p16.predict(s))
        lat.append(1000 * (time.perf_counter() - t0))
    k5_launches = fused_abn_eval.launches
    k10_launches = upsampled_argmax_conf.launches
    peak = torch.cuda.max_memory_allocated()
    forwards = len(batches) + len(singles)
    log(f"[5] bf16 predict_many {len(batches)} x {BATCH}: "
        f"{len(batches) * BATCH / t_many:.2f} img/s; predict 1 x {len(singles)}: "
        f"median {np.median(lat):.3f} ms/request (min {min(lat):.3f}, max "
        f"{max(lat):.3f}); peak memory "
        f"{peak / 2**30:.3f} GiB; launches K5 {k5_launches} K10 {k10_launches} "
        f"over {forwards} forwards")
    assert k5_launches == ABN_PER_FORWARD * forwards, k5_launches
    assert k10_launches == forwards, k10_launches
    for preds, conf in outs + single_outs:
        c = conf.astype(np.float32)
        assert preds.max() < N_CLASSES
        assert bool((c > 1.0 / N_CLASSES).all() and (c <= 1.0).all())
    b16_pred, _ = p16.predict(img1)
    log(f"[5] bf16 preds agreeing with the f32 card run (information): "
        f"{float((b16_pred == g_pred).mean()):.6f}")
    x16 = torch.from_numpy(batches[0]).to(dev)
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: p16._infer(x16), iters=10)
    log(f"[5] device time of one batch-{BATCH} bf16 serving forward: "
        f"{fwd_ms:.3f} ms")

    # kernel times against their plain versions, at the main path's shapes
    # (device time from CUDA-graph replay; "host-launched" adds launch cost)
    k5_ms = k5_plain_ms = k5_host_ms = k5_elems = 0.0
    for shape, count in sorted(abn_shapes(p16, batches[0]).items()):
        k5_elems += count * float(np.prod(shape))
        x = torch.randn(shape, device=dev).to(torch.bfloat16)
        v = [torch.rand(shape[-1], device=dev) + 0.5 for _ in range(4)]
        tk = device_ms(lambda: fused_abn_eval(x, *v, 1e-5, 0.01))
        tp = device_ms(lambda: abn_eval_plain(x, *v, 1e-5, 0.01))
        th = time_ms(lambda: fused_abn_eval(x, *v, 1e-5, 0.01))
        k5_ms += count * tk
        k5_plain_ms += count * tp
        k5_host_ms += count * th
        gbs = 2 * x.numel() * x.element_size() / tk / 1e6
        log(f"[t] K5 {shape} bf16 x{count}: kernel {tk:.4f} ms ({gbs:.0f} GB/s), "
            f"plain {tp:.4f} ms, kernel host-launched {th:.4f} ms")
    sem = torch.randn((BATCH, 32, 32, N_CLASSES), device=dev).to(torch.bfloat16) * 4
    k10_ms = device_ms(lambda: upsampled_argmax_conf(sem, (CROP, CROP)))
    k10_host_ms = time_ms(lambda: upsampled_argmax_conf(sem, (CROP, CROP)))
    # the plain version's device work; its two small interp matrices are
    # copied to the card once here, outside the captured graph
    from bacs_tpu_torch.ops.upsample_argmax import argmax_conf_from
    from bacs_tpu_torch.ops.upsample_tiles import kmats

    kh, kw = (torch.from_numpy(k).to(dev) for k in kmats(sem.shape, (CROP, CROP)))
    k10_plain_ms = device_ms(lambda: argmax_conf_from(torch.einsum(
        "Ww,nHwc->nHWc", kw, torch.einsum("Hh,nhwc->nHwc", kh, sem.float()))))
    k10_bound = upsample_bound("k10", sem, (CROP, CROP))
    log(f"[t] K10 {tuple(sem.shape)}->{CROP}^2 bf16: kernel {k10_ms:.4f} ms (before: "
        f"{EARLIER_KERNEL_MS['k10']}), plain {k10_plain_ms:.4f} ms, kernel host-launched "
        f"{k10_host_ms:.4f} ms, bound {k10_bound[0]:.4f} ms ({k10_bound[1]})")
    log(f"[t] K5 per batch-{BATCH} forward ({ABN_PER_FORWARD} layers): kernel "
        f"{k5_ms:.4f} ms, plain {k5_plain_ms:.4f} ms, kernel host-launched "
        f"{k5_host_ms:.4f} ms")
    busy = profile(p16, batches[0])
    wall = 1000 * t_many / len(batches)
    log(f"[p] device busy {busy:.3f} ms per served batch of {BATCH}; "
        f"predict_many wall {wall:.3f} ms per batch: device idle share "
        f"{1 - busy / wall:.3f}")

    del p16
    torch.cuda.empty_cache()
    # bf16 in and out, one read and one write; a subtract, an FMA and a select
    k5_bound = bound(2 * 2 * k5_elems, 3 * k5_elems)

    # 6. and 7. K1 forward and backward, K2, against their plain versions
    k1f_err = k1b_err = 0.0
    k2_moved = 0
    for shape, out_hw in K10_CASES:
        for dt in (torch.float32, torch.bfloat16):
            e = check_ce(shape, out_hw, dt, dev)
            k1f_err, k1b_err = max(k1f_err, e["val_abs"]), max(k1b_err, e["grad_abs"])
            log(f"[6] K1 {shape}->{out_hw} {str(dt)[6:]}: ok, per-image sum max abs "
                f"err {e['val_abs']:.3g} (rel {e['val_rel']:.3g}), gradient max abs "
                f"err {e['grad_abs']:.3g} (rel {e['grad_rel']:.3g})")
    for shape, out_hw in K10_CASES:
        for dt in (torch.float32, torch.bfloat16):
            moved = check_confusion(shape, out_hw, dt, dev)
            k2_moved = max(k2_moved, moved)
            log(f"[7] K2 {shape}->{out_hw} {str(dt)[6:]}: ok, {moved} pixels "
                "counted differently (all near ties)")

    # 8. one f32 train step, card (kernels) against CPU (plain versions),
    # of the network with identity activations and of the configured one
    ce_step_card_vs_cpu("[8] f32 train step card vs CPU, RN101 4 x 128^2", cfg, params,
                        stats, dev, args.seed)

    # 9. bf16 training at 512^2, batch 16, launches counted
    from bacs_tpu_torch.ops.upsample_ce import (
        bacs_dsem, bacs_sum, ce_dsem, ce_sums_per_image, wce_dsem, wce_sums)
    from bacs_tpu_torch.ops.upsample_confusion import upsampled_confusion

    reset_counts, counts = launch_counters()

    state = train_state(cfg, params, stats, torch.bfloat16, dev)
    train_step, eval_step, _ = ce_steps(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    losses = []
    for _ in range(WARMUP_STEPS):
        state, metrics = train_step(state, synthetic_batch(BATCH, CROP, gen, dev))
        losses.append(float(metrics["loss"]))
    train_batches = [synthetic_batch(BATCH, CROP, gen, dev) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms = []
    for b in train_batches:
        t0 = time.perf_counter()
        state, metrics = train_step(state, b)
        losses.append(float(metrics["loss"]))  # a host read: synchronises
        step_ms.append(1000 * (time.perf_counter() - t0))
    train_counts = counts()
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(step_ms))
    log(f"[9] bf16 train step, batch {BATCH}, {CROP}^2: median {med:.3f} ms "
        f"({BATCH * 1000 / med:.2f} img/s; min {min(step_ms):.3f}, max "
        f"{max(step_ms):.3f} ms over {TRAIN_STEPS} steps); peak memory "
        f"{peak / 2**30:.3f} GiB; launches {train_counts} over {TRAIN_STEPS} steps")
    log(f"[9] loss curve: {' '.join(f'{v:.4f}' for v in losses)}")
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), "the loss did not fall"
    assert train_counts["k1f"] == TRAIN_STEPS and train_counts["k1b"] == TRAIN_STEPS
    assert train_counts["train_abn"] == ABN_PER_FORWARD * TRAIN_STEPS
    assert train_counts["k5"] == train_counts["k2"] == 0
    train_busy = profile_steps(lambda: train_step(state, train_batches[0]),
                               f"bf16 train steps (batch {BATCH}, {CROP}^2)")
    log(f"[p] train: device busy {train_busy:.3f} ms per step (before: "
        f"{EARLIER_BUSY_MS['CE step (phase [9])']}); median step wall "
        f"{med:.3f} ms: device idle share {1 - train_busy / med:.3f}")

    # 10. bf16 eval step at 512^2, batch 16, launches counted
    conf_mat = torch.zeros((N_CLASSES, N_CLASSES), dtype=torch.int32, device=dev)
    eval_step(state, conf_mat.clone(), train_batches[0])  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    eval_ms = []
    for b in train_batches[:EVAL_STEPS]:
        t0 = time.perf_counter()
        conf_mat, loss = eval_step(state, conf_mat, b)
        float(loss)
        eval_ms.append(1000 * (time.perf_counter() - t0))
    eval_counts = counts()
    valid = sum(int((b["label"] != 255).sum()) for b in train_batches[:EVAL_STEPS])
    from bacs_tpu_torch.ops.confusion import iou_from_confusion

    miou = float(iou_from_confusion(conf_mat).miou)
    log(f"[10] bf16 eval step, batch {BATCH}, {CROP}^2: median "
        f"{np.median(eval_ms):.3f} ms (min {min(eval_ms):.3f}); launches "
        f"{eval_counts} over {EVAL_STEPS} steps; confusion counts "
        f"{int(conf_mat.sum())} of {valid} valid pixels; mIoU after "
        f"{WARMUP_STEPS + TRAIN_STEPS} steps {miou:.4f}")
    assert int(conf_mat.sum()) == valid
    assert eval_counts["k5"] == ABN_PER_FORWARD * EVAL_STEPS
    assert eval_counts["k1f"] == eval_counts["k2"] == EVAL_STEPS
    assert eval_counts["k1b"] == eval_counts["train_abn"] == 0
    eval_busy = busy_ms(lambda: eval_step(state, conf_mat.clone(), train_batches[0]))
    log(f"[p] eval: device busy {eval_busy:.3f} ms per step; median step wall "
        f"{np.median(eval_ms):.3f} ms: device idle share "
        f"{1 - eval_busy / np.median(eval_ms):.3f}")

    del state, train_batches
    torch.cuda.empty_cache()

    # 11. and 12. K4 and K3 forward and backward against their plain versions
    k4f_err = k4b_err = k3f_err = k3b_err = 0.0
    for shape, out_hw in WEIGHTED_CASES:
        for dt in (torch.float32, torch.bfloat16):
            e = check_wce(shape, out_hw, dt, dev)
            k4f_err, k4b_err = max(k4f_err, e["val_abs"]), max(k4b_err, e["grad_abs"])
            log(f"[11] K4 {shape}->{out_hw} {str(dt)[6:]}, weights 0 for background "
                f"and the new class: ok, sum max abs err {e['val_abs']:.3g} (rel "
                f"{e['val_rel']:.3g}), gradient max abs err {e['grad_abs']:.3g} (rel "
                f"{e['grad_rel']:.3g})")
    for dt in (torch.float32, torch.bfloat16):
        check_wce((12, 32, 32, 17), (CROP, CROP), dt, dev,
                  weights=torch.zeros(17, device=dev))
    log("[11] K4 with all-zero weights, f32 and bf16: sums and gradient exactly 0")
    for shape, out_hw in WEIGHTED_CASES:
        for dt in (torch.float32, torch.bfloat16):
            for ukd in (True, False):
                e = check_bacs(shape, out_hw, dt, dev, ukd=ukd)
                k3f_err, k3b_err = max(k3f_err, e["val_abs"]), max(k3b_err, e["grad_abs"])
                log(f"[12] K3 {shape}->{out_hw} {str(dt)[6:]} ukd={ukd}, old classes "
                    f"{shape[-1] - 1}: ok, sum max abs err {e['val_abs']:.3g} (rel "
                    f"{e['val_rel']:.3g}), gradient max abs err {e['grad_abs']:.3g} "
                    f"(rel {e['grad_rel']:.3g})")

    # 13. one f32 BACS step, card against CPU
    bacs_step_card_vs_cpu(cfg, args.seed, dev)
    torch.cuda.empty_cache()

    # 14. BACS at 512^2, bf16: end_task of task 0 fills the buffer, then
    # task-1 steps with the launches counted
    from bacs_tpu_torch.methods.bacs import DISTILL_CHUNK

    state, method, t_end, gen = bacs_after_task0(cfg, args.seed, dev)
    buf = state.buffer
    n_valid = int(buf.valid.sum())
    log(f"[14] end_task of task 0 over {FILL_BATCHES} batches of {BATCH} at {CROP}^2: "
        f"{t_end:.3f} s (prototype sweep, snapshot, fill in train mode); buffer "
        f"{n_valid} valid of {buf.size}, num_seen {buf.num_seen}, class counts "
        f"{buf.class_counts.tolist()}; prototype counts {state.proto_counts.tolist()}")
    assert n_valid == BACS_METHOD["buffer_size"] == buf.size
    assert buf.num_seen == FILL_BATCHES * BATCH
    assert float(state.proto_counts[0]) > 0 and state.prev_model is not None
    ctx1, _, (bacs_train, bacs_eval, _) = bacs_steps(1, dev)
    losses = []
    for _ in range(WARMUP_STEPS):
        state, metrics = bacs_train(state, synthetic_batch(BATCH, CROP, gen, dev, 17))
        losses.append(float(metrics["loss"]))
    bacs_batches = [synthetic_batch(BATCH, CROP, gen, dev, 17) for _ in range(BACS_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_ms = []
    for b in bacs_batches:
        t0 = time.perf_counter()
        state, metrics = bacs_train(state, b)
        losses.append(float(metrics["loss"]))  # a host read: synchronises
        step_ms.append(1000 * (time.perf_counter() - t0))
    bacs_counts = counts()
    bacs_peak = torch.cuda.max_memory_allocated()
    bacs_med = float(np.median(step_ms))
    log(f"[14] bf16 BACS step (task 1), batch {BATCH} + replay 2 x "
        f"{BACS_METHOD['replay_minibatch_size']}, {CROP}^2: median {bacs_med:.3f} ms "
        f"({BATCH * 1000 / bacs_med:.2f} img/s of the main batch; min "
        f"{min(step_ms):.3f}, max {max(step_ms):.3f} ms over {BACS_STEPS} steps); peak "
        f"memory {bacs_peak / 2**30:.3f} GiB; launches {bacs_counts} over {BACS_STEPS} "
        f"steps; prototype counts {state.proto_counts.tolist()}")
    log(f"[14] loss: {' '.join(f'{v:.4f}' for v in losses)}")
    assert all(np.isfinite(losses)), losses
    for key in ("k3f", "k3b", "k4f", "k4b"):
        assert bacs_counts[key] == BACS_STEPS, (key, bacs_counts)
    assert bacs_counts["k1f"] == bacs_counts["k1b"] == bacs_counts["k2"] == 0
    assert bacs_counts["train_abn"] == TRAIN_ABN_PER_BACS_STEP * BACS_STEPS
    assert bacs_counts["k5"] == ABN_PER_FORWARD * BACS_STEPS  # the previous model
    assert bool((state.proto_counts[:2] > 0).all())
    bacs_busy, parts = profile_by_kind(lambda: bacs_train(state, bacs_batches[0]),
                                       f"bf16 BACS steps (batch {BATCH}, {CROP}^2)")
    for part, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
        log(f"[p] BACS step by kernel kind: {ms:.3f} ms ({ms / bacs_busy:.1%}) {part}")
    log(f"[p] BACS: device busy {bacs_busy:.3f} ms per step (before: "
        f"{EARLIER_BUSY_MS['BACS step (phase [14])']}); median step wall "
        f"{bacs_med:.3f} ms: device idle share {1 - bacs_busy / bacs_med:.3f}")
    # the teacher distillation alone, forward and backward, at the step's
    # shapes: its wall time by events and its memory (its device time is
    # among the step's parts)
    att = [torch.randn((BATCH, CROP // 16, CROP // 16, 256), device=dev).to(torch.bfloat16)
           for _ in range(2)]
    att[1].requires_grad_()
    seen = torch.rand((BATCH, CROP, CROP, 2), device=dev)
    mask = bacs_batches[0]["label"]
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    distill_ms = time_ms(lambda: method._teacher_distill(att[0], att[1], seen, mask).backward(),
                         iters=5, warmup=1)
    distill_peak = torch.cuda.max_memory_allocated() - mem0
    log(f"[14] teacher distillation forward + backward alone: {distill_ms:.3f} ms, peak "
        f"{distill_peak / 2**30:.3f} GiB above its inputs (chunks of {DISTILL_CHUNK} "
        f"images, recomputed in the backward)")
    # K3 and K4 are added from the kernel times below
    step_parts = bacs_step_parts(state, ctx1, method, bacs_batches[0], att, seen)

    # 15. one bf16 eval step at task 1 (17 classes), launches counted
    conf_mat = torch.zeros((N_CLASSES, N_CLASSES), dtype=torch.int32, device=dev)
    bacs_eval(state, conf_mat.clone(), bacs_batches[0])  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    for b in bacs_batches[:EVAL_STEPS]:
        conf_mat, loss = bacs_eval(state, conf_mat, b)
        assert np.isfinite(float(loss))
    bacs_eval_counts = counts()
    valid = sum(int((b["label"] != 255).sum()) for b in bacs_batches[:EVAL_STEPS])
    log(f"[15] bf16 eval step at task 1, batch {BATCH}: launches {bacs_eval_counts} over "
        f"{EVAL_STEPS} steps; confusion counts {int(conf_mat.sum())} of {valid} valid "
        f"pixels")
    assert int(conf_mat.sum()) == valid
    assert bacs_eval_counts["k5"] == ABN_PER_FORWARD * EVAL_STEPS
    assert bacs_eval_counts["k1f"] == bacs_eval_counts["k2"] == EVAL_STEPS
    assert sum(bacs_eval_counts[k] for k in ("k1b", "k3f", "k3b", "k4f", "k4b",
                                             "train_abn")) == 0
    log(f"[p] task-1 eval: device busy "
        f"{busy_ms(lambda: bacs_eval(state, conf_mat.clone(), bacs_batches[0])):.3f} ms "
        f"per step")
    del state
    torch.cuda.empty_cache()

    # 16.-17. K6-K9 against their plain versions; 18. an f32 MiB and PLOP
    # step card against CPU; 19.-20. MiB and PLOP at 512^2 with the launches
    # counted, and their eval steps
    mib_plop_errs = mib_plop_kernel_checks(dev)
    mib_plop_step_card_vs_cpu(cfg, args.seed, dev)
    torch.cuda.empty_cache()
    mib_plop = mib_plop_steps_512(cfg, params, stats, args.seed, dev, reset_counts, counts)
    mib, plop = mib_plop["loss.MiB"], mib_plop["loss.PlopLoss"]

    # 21. K12 forward and backward against their plain versions
    stem_err = {"k12f": 0.0, "k12b": 0.0}
    for shape, levels in [(sh, None) for sh in STEM_CASES] + [(STEM_TIES, 3)]:
        for dt in (torch.float32, torch.bfloat16):
            e = check_stem(shape, dt, dev, levels=levels)
            stem_err = {"k12f": max(stem_err["k12f"], e["val_abs"]),
                        "k12b": max(stem_err["k12b"], e["grad_abs"])}
            log(f"[21] K12 {shape} {str(dt)[6:]}{' on 3 levels (ties)' if levels else ''}: ok, "
                f"pooled max abs err {e['val_abs']:.3g}, gradient max abs err "
                f"{e['grad_abs']:.3g}, bit-equal {e['bit_equal']}"
                + (f", {e['excluded']} cells in near-tie windows" if dt == torch.bfloat16 else ""))
    stem_raises(dev)
    log("[21] K12 raises on a float16, an odd-height and a non-contiguous CUDA tensor")

    # 22. one f32 train step with the fused stem, card against CPU
    ce_step_card_vs_cpu("[22] f32 train step with the fused stem card vs CPU, RN101 4 x 128^2",
                        cfg, params, stats, dev, args.seed, fused_stem=True)

    # 23. the bf16 512^2 CE step with the fused stem on against off
    stem_steps = stem_step_compare(cfg, params, stats, dev, args.seed, reset_counts, counts)
    log(f"[23] fused stem on against off: wall {stem_steps['on']['med'] - stem_steps['off']['med']:+.3f} "
        f"ms, busy {stem_steps['on']['busy'] - stem_steps['off']['busy']:+.3f} ms (before: "
        f"{EARLIER_BUSY_MS['fused stem on against off (phase [23])']}), peak "
        f"{(stem_steps['on']['peak'] - stem_steps['off']['peak']) / 2**30:+.3f} GiB per step; "
        f"phase [9]'s median with it off was {med:.3f} ms")

    # 24. the continual protocol through the CLI's train(), launches counted
    reset_counts()
    t_cli = time.perf_counter()
    cli = cli_protocol(args.seed)
    cli_counts = counts()
    t_cli = time.perf_counter() - t_cli
    report_cli(cli)
    assert cli_counts["k12f"] == cli["launches"]["k12f"] and cli_counts["k12b"] > 0
    torch.cuda.empty_cache()

    # 25. one f32 ER, SDR and iCaRL step card against CPU; 26. the three at
    # 512^2 with the launches counted, and their eval steps
    t_more = time.perf_counter()
    more_step_card_vs_cpu(cfg, args.seed, dev)
    torch.cuda.empty_cache()
    more = more_steps_512(cfg, params, stats, args.seed, dev, reset_counts, counts)
    er_run, sdr_run, icarl_run = (more[k] for k in MORE_METHODS)

    # 27. the flagship protocol through the port's runner, cut in depth
    reset_counts()
    runner = runner_protocol(args.seed)
    runner_counts = counts()
    for r in runner["records"]:
        log(f"[27] {json.dumps(r)}")
    log(f"[27] bacs_tpu_torch.protocol_compare {' '.join(RUNNER_ARGS)} (cut from 12 epochs "
        f"and 1536 / 192 images): {runner['wall']:.1f} s for the three legs (the kernels "
        f"built); train steps per task over the legs {runner['per_task']}, every loss finite; "
        f"launches {runner_counts}")
    assert runner_counts["k4f"] > 0 and runner_counts["k6f"] > 0 and runner_counts["k7b"] > 0
    t_more = time.perf_counter() - t_more
    torch.cuda.empty_cache()

    # 28. UNet-4 f32 card against CPU; 29. UNet-5 at full width: steps,
    # eval, serving (K10 at scale 1), a BACS step; 30. gradient
    # accumulation; 31. stage remat; 32. the 3-task UNet protocol through
    # the runner
    t_unet = time.perf_counter()
    unet_step_card_vs_cpu(args.seed, dev)
    unet = unet_full_width(args.seed, dev, reset_counts, counts)
    acc = accumulate_checks(cfg, params, stats, args.seed, dev, reset_counts, counts)
    remat = remat_compare(cfg, params, stats, args.seed, dev, reset_counts, counts)
    reset_counts()
    unet_run = unet_runner(args.seed)
    unet_runner_counts = counts()
    for r in unet_run["records"]:
        log(f"[32] {json.dumps(r)}")
    log(f"[32] bacs_tpu_torch.protocol_compare {' '.join(UNET_RUNNER_ARGS)}: "
        f"{unet_run['wall']:.1f} s for the three legs; launches {unet_runner_counts}")
    assert not any(unet_runner_counts.values()), unet_runner_counts
    t_unet = time.perf_counter() - t_unet
    torch.cuda.empty_cache()

    # 33. TranSeg f32 steps card against CPU; 34. TranSeg at the shipped
    # width: CE, eval, serving, its f32 kernels, a BACS+ step; 35. the
    # bacs_transformer_config protocol through the CLI
    t_transeg = time.perf_counter()
    transeg_step_card_vs_cpu(args.seed, dev)
    transeg = transeg_full_width(args.seed, dev, reset_counts, counts)
    transeg_run = transeg_cli(args.seed)
    report_transeg_cli(transeg_run)
    transeg_launches = {k: sum(d[k] for d in (
        transeg["train_counts"], transeg["eval_counts"], transeg["serve_counts"],
        transeg["bacs_counts"], transeg_run["launches"])) for k in counts()}
    t_transeg = time.perf_counter() - t_transeg
    torch.cuda.empty_cache()

    # kernel times at the training shape, beside the plain versions (those
    # copy their interpolation matrices from the host, which a CUDA graph
    # cannot capture, so they are timed host-launched by CUDA events; at
    # these sizes they are bound by the device)
    from bacs_tpu_torch.ops.upsample_ce import ce_dsem_plain, ce_sums_plain
    from bacs_tpu_torch.ops.upsample_confusion import confusion_plain

    labels = synthetic_batch(BATCH, CROP, gen, dev)["label"]
    sem = (torch.randn((BATCH, CROP // 16, CROP // 16, N_CLASSES), device=dev)
           * 3).to(torch.bfloat16)
    g = torch.tensor(1.0 / float((labels != 255).sum()), device=dev)
    hw = (CROP, CROP)
    times = {
        "k1f": (device_ms(lambda: ce_sums_per_image(sem, labels, hw)),
                time_ms(lambda: ce_sums_plain(sem, labels, hw), iters=5)),
        "k1b": (device_ms(lambda: ce_dsem(sem, labels, hw, g)),
                time_ms(lambda: ce_dsem_plain(sem, labels, hw, g), iters=5)),
        "k2": (device_ms(lambda: upsampled_confusion(sem, labels, hw, N_CLASSES)),
               time_ms(lambda: confusion_plain(sem, labels, hw, N_CLASSES), iters=5)),
    }
    bounds = {k: upsample_bound(k, sem, hw, labels) for k in ("k1f", "k1b", "k2")}
    # K2 also on logits whose argmax follows the labels' blocks (most warps
    # fill one bin), beside the unfused library trio
    sem2 = trained_like_logits(labels, N_CLASSES, torch.Generator(device=dev).manual_seed(
        args.seed + 9))
    k2_trained = (device_ms(lambda: upsampled_confusion(sem2, labels, hw, N_CLASSES)),
                  upsample_bound("k2", sem2, hw, labels))
    k2_trio = library_trio_ms(sem, labels, hw, N_CLASSES)
    for name, s2 in (("random", sem), ("trained-like", sem2)):
        log(f"[t] K2 inputs {name}: {one_bin_warps(s2, labels, hw, N_CLASSES):.1%} of its "
            f"warps hold 32 kept pixels of one bin")
    # K3 at the main batch's shape, K4 at the replay batch's, on the labels
    # of the BACS step (17 classes) and its old-class weights
    from bacs_tpu_torch.ops.upsample_ce import (
        bacs_dsem_plain, bacs_sum_plain, wce_dsem_plain, wce_sums_plain)

    lab3 = bacs_batches[0]["label"]
    lab4 = bacs_batches[1]["label"][:BACS_METHOD["replay_minibatch_size"]].contiguous()
    sem3 = (torch.randn((BATCH, CROP // 16, CROP // 16, 17), device=dev) * 3).to(
        torch.bfloat16)
    sem4 = sem3[:lab4.shape[0]].contiguous()
    ms = torch.rand((BATCH, CROP, CROP), device=dev)
    w4 = beta_weights(17, dev)
    g3 = torch.tensor(1.0 / lab3.numel(), device=dev)
    g4 = (1.0 / wce_sums_plain(sem4, lab4, w4, hw)[1]).reshape(())
    times.update({
        "k3f": (device_ms(lambda: bacs_sum(sem3, lab3, ms, hw, 16)),
                time_ms(lambda: bacs_sum_plain(sem3, lab3, ms, hw, 16), iters=5)),
        "k3b": (device_ms(lambda: bacs_dsem(sem3, lab3, ms, hw, g3, 16)),
                time_ms(lambda: bacs_dsem_plain(sem3, lab3, ms, hw, g3, 16), iters=3)),
        "k4f": (device_ms(lambda: wce_sums(sem4, lab4, w4, hw)),
                time_ms(lambda: wce_sums_plain(sem4, lab4, w4, hw), iters=5)),
        "k4b": (device_ms(lambda: wce_dsem(sem4, lab4, w4, hw, g4)),
                time_ms(lambda: wce_dsem_plain(sem4, lab4, w4, hw, g4), iters=5)),
    })
    bounds.update({k: upsample_bound(k, sem3, hw, lab3, ms) for k in ("k3f", "k3b")})
    bounds.update({k: upsample_bound(k, sem4, hw, lab4, w4) for k in ("k4f", "k4b")})
    # the unfused library pair (interpolate + cross_entropy) beside K1 and K4
    library = {}
    library["k1f"], library["k1b"] = library_pair_ms(sem, labels, hw)
    library["k4f"], library["k4b"] = library_pair_ms(sem4, lab4, hw, weight=w4)
    for key, name, shape in (
            ("k1f", "K1 forward", sem.shape), ("k1b", "K1 backward", sem.shape),
            ("k2", "K2", sem.shape), ("k3f", "K3 forward", sem3.shape),
            ("k3b", "K3 backward", sem3.shape), ("k4f", "K4 forward", sem4.shape),
            ("k4b", "K4 backward", sem4.shape)):
        log(f"[t] {name} {tuple(shape)}->{CROP}^2 bf16, int32 labels: kernel "
            f"{times[key][0]:.4f} ms"
            + (f" (before: {EARLIER_KERNEL_MS[key]})" if key in EARLIER_KERNEL_MS else "")
            + f", plain {times[key][1]:.4f} ms, bound {bounds[key][0]:.4f} ms "
            f"({bounds[key][1]})"
            + (f", library pair F.interpolate + F.cross_entropy {library[key]:.4f} ms "
               "(host-launched, CUDA events)" if key in library else "")
            + (f", library trio F.interpolate + argmax + torch.bincount {k2_trio:.4f} ms "
               "(host-launched, CUDA events)" if key == "k2" else ""))
    log(f"[t] K2 on trained-like logits {tuple(sem2.shape)}->{CROP}^2 bf16 (the argmax "
        f"follows the label blocks), int32 labels: kernel {k2_trained[0]:.4f} ms, bound "
        f"{k2_trained[1][0]:.4f} ms ({k2_trained[1][1]})")
    # two launches of each kernel of the family on the same inputs are
    # bit-equal, at the main path's shapes
    check_repeatable(family_calls(dev, args.seed))
    log("[t] K1, K3, K4, K6, K7, K12 forward and backward, K2, K8, K9 and K10: two "
        "launches bit-equal at the main path's shapes")
    log(f"[t] bounds: K5 {k5_bound[0]:.4f} ms per forward ({k5_bound[1]}), K10 "
        f"{k10_bound[0]:.4f} ms ({k10_bound[1]})")
    mp_times, mp_bounds = mib_plop_kernel_times(dev, args.seed)
    stem_times = stem_kernel_times(dev)
    step_parts["K3 and K4, forward + backward"] = sum(
        times[k][0] for k in ("k3f", "k3b", "k4f", "k4b"))
    for part, ms in step_parts.items():
        log(f"[p] BACS step alone by part: {ms:.3f} ms ({ms / bacs_busy:.1%} of the "
            f"step's busy time) {part}")
    rest = bacs_busy - sum(step_parts.values())
    log(f"[p] BACS step alone by part: {rest:.3f} ms ({rest / bacs_busy:.1%}) the rest "
        f"(losses, prototype folds, replay draws, augmentation, autocontrast)")

    log(f"[time] {time.perf_counter() - t_main:.1f} s from the build to here, phase [24] "
        f"{t_cli:.1f} s, phases [25]-[27] {t_more:.1f} s, phases [28]-[32] {t_unet:.1f} s, "
        f"phases [33]-[35] {t_transeg:.1f} s")

    def entry(name, route, source, replaces, launches, err, ms, plain_ms, bnd, **extra):
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                # no single PyTorch call computes any of these functions
                # (an interpolate and a cross-entropy are two calls: K1's
                # and K4's rows carry that pair, as K12's its unfused pair)
                "library_ms": None, **extra}

    def with_pair(row, key):
        return {**row, "library_ms": library[key],
                "library_is": "the unfused pair F.interpolate(bilinear, align_corners="
                              "False) + F.cross_entropy(reduction='sum', ignore_index=255"
                              + (", weight=w" if key.startswith("k4") else "")
                              + "), host-launched CUDA events"}

    rows = [
        entry("abn_apply (K5)", "triton", "bacs_tpu_torch/ops/abn_core.py",
              "bacs_tpu/ops/abn_pallas.py:45",
              k5_launches + eval_counts["k5"] + train_counts["train_abn"]
              + bacs_counts["k5"] + bacs_counts["train_abn"] + bacs_eval_counts["k5"]
              + sum(r[p][k] for r in (mib, plop, er_run, sdr_run, icarl_run) for p, k in (
                  ("steps", "k5"), ("steps", "train_abn"), ("eval", "k5")))
              + runner_counts["k5"] + runner_counts["train_abn"]
              + acc["counts"]["train_abn"] + remat["counts"]["train_abn"],
              k5_err, k5_ms, k5_plain_ms, k5_bound,
              launches_by_path={"serve": k5_launches, "eval_step": eval_counts["k5"],
                                "train_step_abn": train_counts["train_abn"],
                                "bacs_step_prev_model": bacs_counts["k5"],
                                "bacs_step_abn": bacs_counts["train_abn"],
                                "bacs_eval_step": bacs_eval_counts["k5"],
                                "mib_step_prev_model": mib["steps"]["k5"],
                                "mib_step_abn": mib["steps"]["train_abn"],
                                "plop_step_prev_model": plop["steps"]["k5"],
                                "plop_step_abn": plop["steps"]["train_abn"],
                                "mib_plop_eval_steps": mib["eval"]["k5"] + plop["eval"]["k5"],
                                "er_sdr_icarl_steps": sum(
                                    r["steps"][k] for r in (er_run, sdr_run, icarl_run)
                                    for k in ("k5", "train_abn")),
                                "er_sdr_icarl_eval_steps": sum(
                                    r["eval"]["k5"] for r in (er_run, sdr_run, icarl_run)),
                                "protocol_runner": runner_counts["k5"]
                                + runner_counts["train_abn"],
                                "accumulated_step_abn": acc["counts"]["train_abn"],
                                "remat_steps_abn": remat["counts"]["train_abn"]}),
        entry("upsample_argmax_conf (K10)", "cuda",
              "bacs_tpu_torch/csrc/upsample_argmax.cu",
              "bacs_tpu/ops/upsample_argmax.py:88",
              k10_launches + unet["serve_counts"]["k10"], max(k10_err, unet["k10_x1"]["err"]),
              k10_ms, k10_plain_ms, k10_bound,
              launches_by_path={"serve_deeplab": k10_launches,
                                "serve_unet_scale_1": unet["serve_counts"]["k10"]},
              scale_1_ms=unet["k10_x1"]["ms"], scale_1_plain_ms=unet["k10_x1"]["plain_ms"],
              scale_1_bound_ms=unet["k10_x1"]["bound"][0],
              scale_1_bound_by=unet["k10_x1"]["bound"][1],
              scale_1_is="UNet-5's served logits [16, 512, 512, 21] bf16 -> 512^2"),
        with_pair(entry("upsample_ce_sums (K1 forward)", "cuda",
                        "bacs_tpu_torch/csrc/upsample_ce.cu",
                        "bacs_tpu/ops/upsample_ce.py:787",
                        train_counts["k1f"] + eval_counts["k1f"] + bacs_eval_counts["k1f"]
                        + plop["steps"]["k1f"] + mib["eval"]["k1f"] + plop["eval"]["k1f"]
                        + er_run["steps"]["k1f"] + er_run["eval"]["k1f"]
                        + runner_counts["k1f"] + acc["counts"]["k1f"]
                        + remat["counts"]["k1f"],
                        k1f_err, *times["k1f"], bounds["k1f"]), "k1f"),
        with_pair(entry("upsample_ce_grad (K1 backward)", "cuda",
                        "bacs_tpu_torch/csrc/upsample_ce.cu",
                        "bacs_tpu/ops/upsample_ce.py:125",
                        train_counts["k1b"] + er_run["steps"]["k1b"] + runner_counts["k1b"]
                        + acc["counts"]["k1b"] + remat["counts"]["k1b"],
                        k1b_err,
                        *times["k1b"], bounds["k1b"]), "k1b"),
        entry("upsample_confusion (K2)", "cuda",
              "bacs_tpu_torch/csrc/upsample_confusion.cu",
              "bacs_tpu/ops/upsample_confusion.py:88",
              eval_counts["k2"] + bacs_eval_counts["k2"] + mib["eval"]["k2"]
              + plop["eval"]["k2"] + sum(r["eval"]["k2"] for r in (er_run, sdr_run, icarl_run))
              + runner_counts["k2"],
              k2_moved, *times["k2"], bounds["k2"],
              trained_like_ms=k2_trained[0], trained_like_bound_ms=k2_trained[1][0],
              library_trio_ms=k2_trio,
              library_trio_is="F.interpolate(bilinear, align_corners=False) + argmax + "
                              "torch.bincount, three calls, host-launched CUDA events"),
        entry("upsample_bacs_sum (K3 forward)", "cuda",
              "bacs_tpu_torch/csrc/upsample_bacs.cu", "bacs_tpu/ops/upsample_ce.py:396",
              bacs_counts["k3f"], k3f_err, *times["k3f"], bounds["k3f"]),
        entry("upsample_bacs_grad (K3 backward)", "cuda",
              "bacs_tpu_torch/csrc/upsample_bacs.cu", "bacs_tpu/ops/upsample_ce.py:396",
              bacs_counts["k3b"], k3b_err, *times["k3b"], bounds["k3b"]),
        with_pair(entry("upsample_wce_sums (K4 forward)", "cuda",
                        "bacs_tpu_torch/csrc/upsample_wce.cu",
                        "bacs_tpu/ops/upsample_ce.py:233",
                        bacs_counts["k4f"] + er_run["steps"]["k4f"] + runner_counts["k4f"],
                        k4f_err,
                        *times["k4f"], bounds["k4f"],
                        launches_by_path={"bacs_step": bacs_counts["k4f"],
                                          "er_step_replay": er_run["steps"]["k4f"],
                                          "protocol_runner": runner_counts["k4f"]}), "k4f"),
        with_pair(entry("upsample_wce_grad (K4 backward)", "cuda",
                        "bacs_tpu_torch/csrc/upsample_wce.cu",
                        "bacs_tpu/ops/upsample_ce.py:243",
                        bacs_counts["k4b"] + er_run["steps"]["k4b"] + runner_counts["k4b"],
                        k4b_err,
                        *times["k4b"], bounds["k4b"],
                        launches_by_path={"bacs_step": bacs_counts["k4b"],
                                          "er_step_replay": er_run["steps"]["k4b"],
                                          "protocol_runner": runner_counts["k4b"]}), "k4b"),
        *(entry(name, "cuda", source, replaces,
                run[key] + sdr_run["steps"][key] + sdr_run["eval"][key] + runner_counts[key],
                mib_plop_errs[key], *mp_times[key], mp_bounds[key],
                launches_by_path={"mib_or_plop_step": run[key],
                                  "sdr_step": sdr_run["steps"][key],
                                  "sdr_eval_step": sdr_run["eval"][key],
                                  "protocol_runner": runner_counts[key]})
          for name, source, replaces, run, key in (
              ("upsample_uce_sums (K6 forward)", "bacs_tpu_torch/csrc/upsample_uce.cu",
               "bacs_tpu/ops/upsample_ce.py:543", mib["steps"], "k6f"),
              ("upsample_uce_grad (K6 backward)", "bacs_tpu_torch/csrc/upsample_uce.cu",
               "bacs_tpu/ops/upsample_ce.py:543", mib["steps"], "k6b"),
              ("upsample_ukd_sum (K7 forward)", "bacs_tpu_torch/csrc/upsample_ukd.cu",
               "bacs_tpu/ops/upsample_ce.py:695", mib["steps"], "k7f"),
              ("upsample_ukd_grad (K7 backward)", "bacs_tpu_torch/csrc/upsample_ukd.cu",
               "bacs_tpu/ops/upsample_ce.py:695", mib["steps"], "k7b"),
              ("upsample_ce_grad_per_image (K8)", "bacs_tpu_torch/csrc/upsample_ce.cu",
               "bacs_tpu/ops/upsample_ce.py:125", plop["steps"], "k8"),
              ("upsample_plop_pseudo (K9)", "bacs_tpu_torch/csrc/upsample_pseudo.cu",
               "bacs_tpu/ops/upsample_ce.py:904", plop["steps"], "k9"))),
        *({**entry(name, "cuda", "bacs_tpu_torch/csrc/stem_pool.cu", replaces,
                   cli_counts[key], stem_err[key], stem_times[key][0], stem_times[key][1],
                   stem_times[key][4],
                   launches_by_path={"cli_protocol": cli_counts[key],
                                     "ce_step_fused_stem": stem_steps["on"]["counts"][key]},
                   fused_abn_pool_ms=stem_times[key][3],
                   library_is="the unfused pair the port runs with fused_stem off: "
                              "fused_abn (K5 apply) + F.max_pool2d (autograd backward for "
                              "the backward), CUDA events"),
            "library_ms": stem_times[key][2]}
          for name, replaces, key in (
              ("stem_pool_fwd (K12 forward)", "bacs_tpu/ops/stem_pool.py:232", "k12f"),
              ("stem_pool_grad (K12 backward)", "bacs_tpu/ops/stem_pool.py:338", "k12b"))),
    ]
    # TranSeg's path ([34], [35]): its launches, and the upsample kernels on
    # its float32 logits ([34]'s shapes)
    for row in rows:
        keys = next(v for k, v in TRANSEG_ROW_KEYS.items() if row["name"].endswith(k))
        row["launches"] += sum(transeg_launches[k] for k in keys)
        row["transeg_launches"] = sum(transeg_launches[k] for k in keys)
        if keys[0] in transeg["f32"]:
            err, ms, plain_ms, bnd = transeg["f32"][keys[0]]
            row.update(f32_ms=ms, f32_plain_ms=plain_ms, f32_bound_ms=bnd[0],
                       f32_bound_by=bnd[1], f32_max_abs_err=err,
                       f32_is="float32 logits at TranSeg's shapes (phase [34])")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
