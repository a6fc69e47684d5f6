#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout.  It builds the hand-written kernels from
``bacs_tpu_torch/csrc`` (nvcc, into ``build/``) and Triton at first use
(Triton's cache also under ``build/``), then:

1. prints the environment, the card's ``nvidia-smi`` name and power limit,
   and the build time;
2. holds the eval-ABN kernel (K5, Triton) against its plain PyTorch version
   at the ResNet-101 serving forward's shapes at batch 16;
3. holds the upsample+argmax+confidence kernel (K10, CUDA) against its plain
   version;
4. runs the full DeepLabV3-ResNet-101 Predictor at 512^2, batch 1, in f32 on
   the card (kernels) and on the CPU (plain versions) and compares them;
5. serves bf16 batches through ``Predictor.predict_many`` (16 x 8) and
   ``Predictor.predict`` (1 x 20) with the launch counters reset just
   before, and asserts 107 K5 launches and 1 K10 launch per forward;
   then times each kernel against its plain version at the forward's
   shapes, and profiles two served batches (a table of device time by
   operator and kernel; device busy time and idle share).

Weights are random, made from ``--seed``.  A failed check raises, so the
script exits nonzero and prints no result.  The last three lines are a
JSON object of the kernels' launches, errors and times, the card's
``nvidia-smi`` name and power limit, and the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_CLASSES = 21  # conf/bacs/dataset/voc.yaml
CROP = 512
BATCH = 16
NETWORK_YAML = "conf/bacs/network/deep_lab.yaml"
K5_SHAPES = [(16, 256, 256, 64), (16, 128, 128, 256), (16, 64, 64, 512),
             (16, 32, 32, 1024), (16, 32, 32, 2048), (16, 1, 1, 256)]
K10_CASES = [((16, 32, 32, 21), (512, 512)), ((1, 32, 32, 21), (512, 512)),
             ((2, 33, 47, 21), (261, 373)), ((2, 8, 8, 150), (128, 128))]
ABN_PER_FORWARD = 107  # stem 1 + 33 bottlenecks x 3 + 4 proj_bn + ASPP 3


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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


def check_argmax(shape, out_hw, dtype, device, seed=0) -> float:
    """K10 against its plain version; returns the max abs confidence error."""
    from bacs_tpu_torch.ops.upsample_argmax import (
        argmax_conf_from, upsampled_argmax_conf)
    from bacs_tpu_torch.ops.upsample_tiles import kmats

    g = torch.Generator(device=device).manual_seed(seed)
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
    err = float((conf.float() - ref_c.float()).abs().max())
    assert err <= 1e-3, f"confidence error {err}"
    return err


# ---------------------------------------------------------------- model


def network_cfg() -> dict:
    import yaml

    with open(NETWORK_YAML) as f:
        return yaml.safe_load(f)


def seeded_variables(cfg: dict, seed: int):
    """Flax-layout (params, batch_stats) for the configured network.

    Convs are drawn as the JAX package initialises them (He normal over
    fan-out; LeCun normal for the classifier), ABN scale and bias with a
    seeded spread; each bottleneck's last ABN scale is small, as in
    zero-init-residual training, which keeps the random 101-layer network
    from being chaotic (bf16 rounding would otherwise flip most argmaxes).
    The running statistics are then calibrated: one small CPU forward sets
    every ABN's mean and variance to those of its actual input, so
    activations keep a trained network's scale through 101 layers instead
    of growing without bound.
    """
    from bacs_tpu_torch.data.transforms import normalize_image
    from bacs_tpu_torch.models import create_network
    from bacs_tpu_torch.models.norm import ABN
    from bacs_tpu_torch.utils.flax_weights import state_dict_to_flax

    model = create_network(cfg["_target_"], N_CLASSES, norm=cfg["norm"],
                           backbone=cfg["backbone"]).eval()
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, t in model.state_dict().items():
        if t.dim() == 4:  # conv weight [out, in, kh, kw]
            std = (2.0 / (t.shape[0] * t.shape[2] * t.shape[3])) ** 0.5
            if k.startswith("classifier_head"):
                std = (1.0 / (t.shape[1] * t.shape[2] * t.shape[3])) ** 0.5
            sd[k] = torch.randn(t.shape, generator=g) * std
        elif k.endswith("bn3.weight"):  # damped residual branch
            sd[k] = 0.1 + 0.2 * torch.rand(t.shape, generator=g)
        elif k.endswith("weight"):  # ABN scale
            sd[k] = 0.5 + torch.rand(t.shape, generator=g)
        elif k.endswith("bias"):
            sd[k] = (torch.rand(t.shape, generator=g) - 0.5) * 0.2
        else:  # running statistics, calibrated below
            sd[k] = t.clone()
    model.load_state_dict(sd)

    def calibrate(m, inputs):
        x = inputs[0].float()
        m.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        m.running_var.copy_(x.var(dim=(0, 2, 3), unbiased=False).clamp_min(1e-3))

    handles = [m.register_forward_pre_hook(calibrate) for m in model.modules()
               if isinstance(m, ABN)]
    img = torch.randint(0, 256, (4, 128, 128, 3), generator=g, dtype=torch.uint8)
    with torch.no_grad():
        model.sem_logits(normalize_image(img))
    for h in handles:
        h.remove()
    return state_dict_to_flax(model.state_dict())


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
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            predictor.predict(images_u8)
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 1000 / 2
    log("[p] profile of 2 served batches (batch 16, bf16), by device time:")
    log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=30,
                                  max_name_column_width=48))
    return busy_ms


# ---------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
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

    # 1. environment and build
    log(f"[1] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    log(f"[1] nvidia-smi: {smi}")
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.load_library()
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
    k5_ms = k5_plain_ms = k5_host_ms = 0.0
    for shape, count in sorted(abn_shapes(p16, batches[0]).items()):
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
    log(f"[t] K10 {tuple(sem.shape)}->{CROP}^2 bf16: kernel {k10_ms:.4f} ms, "
        f"plain {k10_plain_ms:.4f} ms, kernel host-launched {k10_host_ms:.4f} ms")
    log(f"[t] K5 per batch-{BATCH} forward ({ABN_PER_FORWARD} layers): kernel "
        f"{k5_ms:.4f} ms, plain {k5_plain_ms:.4f} ms, kernel host-launched "
        f"{k5_host_ms:.4f} ms")
    busy = profile(p16, batches[0])
    wall = 1000 * t_many / len(batches)
    log(f"[p] device busy {busy:.3f} ms per served batch of {BATCH}; "
        f"predict_many wall {wall:.3f} ms per batch: device idle share "
        f"{1 - busy / wall:.3f}")

    print(json.dumps({"kernels": [
        {"name": "abn_eval (K5)", "route": "triton",
         "source": "bacs_tpu_torch/ops/abn_core.py",
         "replaces": "bacs_tpu/ops/abn_pallas.py:45",
         "launches": k5_launches, "max_abs_err": k5_err,
         "ms": k5_ms, "plain_ms": k5_plain_ms},
        {"name": "upsample_argmax_conf (K10)", "route": "cuda",
         "source": "bacs_tpu_torch/csrc/upsample_argmax.cu",
         "replaces": "bacs_tpu/ops/upsample_argmax.py:88",
         "launches": k10_launches, "max_abs_err": k10_err,
         "ms": k10_ms, "plain_ms": k10_plain_ms},
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
