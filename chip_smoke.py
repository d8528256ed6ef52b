#!/usr/bin/env python3
"""Bring-up check of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --profile profile_out   # + per-op tables

Phases, each reported on its own lines:
  device  card name and power limit (nvidia-smi), torch / CUDA versions;
  build   compiles every csrc/*.cu with nvcc for sm_90a, one process each,
          all started together, timed, with ptxas' register / spill lines;
  kernel  the packed attention kernel against its plain PyTorch version on
          the card, at the serving shape and at ragged small shapes, with
          CUDA-event times of both; the share of outputs that differ from
          the plain version at all is what tells a kernel that rounds e to
          bf16 before the denominator from one that does not;
  slice   the zero-shot serving path: build_zero_shot (ViT-B/16, T=8, 224^2,
          400 classes, random seeded weights) + inject_clip_pathologies, a
          bf16 VideoClassifier at batch 16, warmup, classify_clips on 16 and
          on 5 seeded clips; checks the probabilities, 12 kernel launches
          per forward, and the logits against the plain-attention bf16
          forward and an fp32 reference (on these weights and on the plain
          init); clips/s and batch-1 latency;
  server  that classifier behind gava_clip_tpu_torch.server.serve on
          localhost, 4 concurrent /v1/classify_clip_raw requests.
The w8a8 path gets the same three checks:
  w8a8-kernel  the four int8 kernels (w8a8_matmul, w8a8_matmul3_cat,
          attention_out_int8, w8a8_mlp_res) against their plain versions at
          the serving shapes and ragged ones, with CUDA-event times of both
          (limits in W8A8_LIMITS);
  w8a8-slice   VideoClassifier(quantize="w8a8", patch_major=True) on the
          pathology weights at batch 16: launches per forward (1, 12, 12, 12
          and no packed attention), probabilities, the padded bucket, the
          logits against the same forward through the plain versions (on
          these weights and on the plain init), the prob-delta gate against
          the bf16 classifier, clips/s and batch-1 latency;
  w8a8-server  the w8a8 classifier behind the same server.
The training step:
  train-kernel  the denominator-emitting packed forward, the packed
          backward and the streaming (causal / long) forward and backward
          against their plain versions at the training shapes and ragged
          ones (limits in TRAIN_LIMITS), with CUDA-event times of kernel,
          plain version and F.scaled_dot_product_attention (a yardstick
          only);
  train-slice   build_flagship (ViT-B/16, T=8, text tower 12 x 512, KAPT
          prompts over 5 knowledge versions, memory + NTE heads, random
          seeded weights) -> trainable_mask -> create_train_state ->
          make_train_step, bf16, attn_impl="flash", batch 16 clips: the
          first step's loss and gradients against the same step through the
          plain versions, then 6 steps on a fixed batch: launches per step
          (12 each of the four kernels, no plain packed forward), the loss
          falls, frozen leaves bit-unchanged, trainable leaves moved,
          ms/step and peak memory;
  train-long    steps at 4 clips x 70 frames with remat="full".
The training and evaluation programs:
  train-recompute  the same step under set_flash_bwd_mode("recompute"): the
          first step's loss and gradients against the saved mode, 3 steps
          with 12 launches each of the recompute backward and of the
          forward that writes no denominators; the mode reset and the
          saved-mode gradients back bit for bit;
  driver  writes a synthetic fold from a seed into a temporary directory
          (lists, separable uint8 clips as decoded-view cache files, NTE
          arrays, the memory pickle, the knowledge directory, a classes
          file) and runs gava_clip_tpu_torch.cli.train.main at full width,
          16 clips x 8 frames, bf16: 12 steps with one evaluation and
          periodic checkpoints; the loss falls, the run's files exist,
          prefetch on and off give the same losses, a run resumed with
          --auto_resume repeats the uninterrupted run's losses, the clamp
          monitor stays below 110; then cli.evaluate.main on that run
          (plain and --quantize_eval w8a8) and cli.zero_shot.main on a
          reference-format .pth written from a model's own weights;
  driver-long  cli.train.main at 4 clips x 70 frames (selects
          save_attn_qkv), then the bare step under every remat policy:
          ms/step, peak memory, attention forward launches per step.
The two-source attention + int8 out-projection (attention_out_int8_2src)
is held in w8a8-kernel against its plain version and, bit for bit, against
the single-source kernel on the concatenated keys, and launched once
through its public entry point at the serving shape in w8-slice.
The remaining serving modes:
  w8-kernel    the weight-only int8 GEMM (int8_matmul), the residual-free
          w8a8 MLP (w8a8_mlp), the fused prompt extras (fused_extras) and
          the int8 QK^T form of attention_out_int8 against their plain
          versions at the serving shapes and ragged ones (limits in
          W8_LIMITS, EXTRAS_LIMITS, W8A8_LIMITS), with CUDA-event times of
          kernel, plain version and, where there is one, a stock PyTorch
          yardstick; the qkv kernel without extras rows is timed here too;
  w8-slice     VideoClassifier(quantize="w8") at batch 16: 72 int8_matmul
          and 12 packed_attention launches per forward, the logits against
          the same forward through the plain versions and against the bf16
          forward, the prob-delta gate, clips/s, batch-1 latency; the
          patch-major w8 classifier beside it; mlp_block(residual=None) on
          w8a8 leaves at the tower's shape;
  w8a8-variants  the w8a8 + patch-major classifier with set_fused_extras,
          then with set_int8_qk as well: launches per forward, logits
          against the unfused forward and the plain-version forward, the
          gate, times beside the unfused forward; both switches reset;
  w8-server    the w8 classifier behind the same server.

Any failure raises and the script exits nonzero without printing a result.
On success the line before the last but one is a JSON object describing
each kernel (time, plain version's time, its bound on this card, the
library call's time where there is one, launches on its main path) and the
last line is {"ok": true, "device": {...}}. Imports no JAX and nothing of
the JAX package.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# the kernels' symbols, as a device trace names them
KERNEL_SYMBOLS = ("packed_attention_kernel", "w8a8_matmul_kernel",
                  "w8a8_qkv_cat_kernel", "attention_out_int8_kernel",
                  "w8a8_mlp_res_kernel", "attn_bwd_dq_kernel",
                  "attn_bwd_dkdv_kernel", "streaming_attention_fwd_kernel",
                  "w8_matmul_kernel", "fused_extras_kernel",
                  "recompute_stats_kernel")
KERNEL_SOURCE = "gava_clip_tpu_torch/csrc/packed_attention.cu"
KERNEL_REPLACES = "gava_clip_tpu/ops/flash_attention.py:181"
# every kernel of the two serving paths and of the training step:
# launch-count name -> (library, source, the TPU kernel it replaces)
KERNELS = {
    "packed_attention": ("packed_attention", KERNEL_SOURCE, KERNEL_REPLACES),
    "w8a8_matmul": ("w8a8_matmul", "gava_clip_tpu_torch/csrc/w8a8_matmul.cu",
                    "gava_clip_tpu/ops/int8_matmul.py:374"),
    "w8a8_matmul3_cat": ("w8a8_qkv", "gava_clip_tpu_torch/csrc/w8a8_qkv.cu",
                         "gava_clip_tpu/ops/int8_matmul.py:514"),
    "attention_out_int8": (
        "attention_out_int8",
        "gava_clip_tpu_torch/csrc/attention_out_int8.cu",
        "gava_clip_tpu/ops/flash_attention.py:661"),
    "w8a8_mlp_res": ("w8a8_mlp", "gava_clip_tpu_torch/csrc/w8a8_mlp.cu",
                     "gava_clip_tpu/ops/int8_matmul.py:694"),
    "packed_attention_den": ("packed_attention", KERNEL_SOURCE,
                             "gava_clip_tpu/ops/flash_attention.py:193"),
    "packed_attention_bwd": (
        "packed_attention_bwd",
        "gava_clip_tpu_torch/csrc/packed_attention_bwd.cu",
        "gava_clip_tpu/ops/flash_attention.py:213"),
    "streaming_attention": (
        "streaming_attention",
        "gava_clip_tpu_torch/csrc/streaming_attention.cu",
        "gava_clip_tpu/ops/flash_attention.py:534"),
    "streaming_attention_bwd": (
        "streaming_attention_bwd",
        "gava_clip_tpu_torch/csrc/streaming_attention_bwd.cu",
        "gava_clip_tpu/ops/flash_attention.py:534"),
    "int8_matmul": ("w8_matmul", "gava_clip_tpu_torch/csrc/w8_matmul.cu",
                    "gava_clip_tpu/ops/int8_matmul.py:54"),
    "w8a8_mlp": ("w8a8_mlp", "gava_clip_tpu_torch/csrc/w8a8_mlp.cu",
                 "gava_clip_tpu/ops/int8_matmul.py:594"),
    "fused_extras": ("fused_extras",
                     "gava_clip_tpu_torch/csrc/fused_extras.cu",
                     "gava_clip_tpu/ops/extras_kernel.py:48"),
    "attention_out_int8_qk8": (
        "attention_out_int8",
        "gava_clip_tpu_torch/csrc/attention_out_int8.cu",
        "gava_clip_tpu/ops/flash_attention.py:117"),
    "packed_attention_bwd_recompute": (
        "packed_attention_bwd_recompute",
        "gava_clip_tpu_torch/csrc/packed_attention_bwd_recompute.cu",
        "gava_clip_tpu/ops/flash_attention.py:410"),
    "attention_out_int8_2src": (
        "attention_out_int8",
        "gava_clip_tpu_torch/csrc/attention_out_int8.cu",
        "gava_clip_tpu/ops/flash_attention.py:775"),
}
# (B, Lq, Lk, heads, head_dim); the first is the serving shape: 16 clips x
# 8 frames, 197 query tokens, 197 + 8 global + 1 summary + 8 local keys
KERNEL_SHAPES = ((128, 197, 214, 12, 64), (3, 13, 21, 2, 64),
                 (2, 77, 150, 4, 64), (2, 65, 64, 3, 64))
# kernel vs plain version: most outputs that may differ at all, and most
# that may differ by more than 2 bf16 ulps (see phase_kernel)
MAX_DIFF_SHARE = 5e-3
MAX_FAR_SHARE = 1e-3


def log(*a):
    print(*a, flush=True)


def import_port():
    """Import the port from this checkout (and nowhere else)."""
    sys.path.insert(0, ROOT)
    import gava_clip_tpu_torch
    where = os.path.dirname(os.path.abspath(gava_clip_tpu_torch.__file__))
    if os.path.dirname(where) != ROOT:
        raise RuntimeError(f"gava_clip_tpu_torch imported from {where}, "
                           f"not from this checkout {ROOT}")
    _assert_no_jax()


def _assert_no_jax():
    """Neither JAX nor any module of the JAX package may be loaded."""
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.") or m == "gava_clip_tpu"
                 or m.startswith("gava_clip_tpu."))
    if bad:
        raise AssertionError(f"JAX or the JAX package was imported: {bad[:5]}")


def bf16_ulp(x):
    import torch
    mag = x.abs().float().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 10) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(state):
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    state["smi"] = smi
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] python {sys.version.split()[0]}, torch {torch.__version__},"
        f" CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"capability {torch.cuda.get_device_capability(0)}, "
        f"count {torch.cuda.device_count()}")
    # a second of load first, so that the timings below do not catch the
    # card's clocks still ramping up from idle
    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


def _card_state() -> str:
    """SM clock, power draw and temperature right now (a run whose clocks
    fell mid-way shows here)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True)
    return res.stdout.strip() or "nvidia-smi gave nothing"


def phase_build(state):
    """Every kernel source, one nvcc each, all started together."""
    from gava_clip_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    libs = sorted({lib for lib, _, _ in KERNELS.values()})
    _cuda.load_libraries(libs)
    log(f"[build] {len(libs)} sources built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        info = _cuda.build_info[lib]
        log(f"[build] {lib}: nvcc {info['seconds']:.2f} s -> {info['so']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")


def phase_kernel(state):
    import torch
    from gava_clip_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    def check(name, q, k, v, H):
        out = fa.packed_attention_cuda(q, k, v, H)
        ref = fa.packed_attention_plain(q, k, v, H)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        ulp = bf16_ulp(ref)
        # Both versions round each weight e to bf16 and the output once;
        # only their fp32 summation orders differ. That leaves an output
        # bf16 value different from the plain one only where an fp32 sum
        # lands next to a rounding boundary: a small share of elements
        # (MAX_DIFF_SHARE). A kernel that summed the unrounded fp32 e into
        # the denominator moves every row by up to 2**-9 relative and so
        # changes a few percent of the outputs by one ulp. Beyond 2 ulps
        # are only outputs that cancel to near 0 (tiny ulps) or rows where
        # a score flips an e rounding: a flip moves that weight by at most
        # 2**-8 of itself, so the output by at most 2**-8 * sum_i p_i |v_i|
        # (the plain version on |v|), the ceiling for those few.
        spread = fa.packed_attention_plain(q, k, v.abs(), H).float()
        ceiling = 2.0 ** -8 * spread + 2 * ulp + 1e-6
        diff_share = (err > 0).float().mean().item()
        far_share = (err > 2 * ulp).float().mean().item()
        ok = (bool(torch.isfinite(out).all()) and diff_share <= MAX_DIFF_SHARE
              and far_share <= MAX_FAR_SHARE and bool((err <= ceiling).all()))
        log(f"[kernel] {name}: max_abs_err {err.max().item():.3e}; share of "
            f"outputs != plain {diff_share:.3e} (limit {MAX_DIFF_SHARE:g}), "
            f"> 2 bf16 ulp {far_share:.3e} (limit {MAX_FAR_SHARE:g}); max "
            f"err/ceiling {(err / ceiling).max().item():.3f} (ceiling 2^-8 * "
            f"sum p|v| + 2 ulp) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees at {name}")
        return err.max().item()

    for i, (B, Lq, Lk, H, Dh) in enumerate(KERNEL_SHAPES):
        D = H * Dh
        q, k, v = rand(B, Lq, D), rand(B, Lk, D), rand(B, Lk, D)
        err = check(f"B={B} Lq={Lq} Lk={Lk} H={H} Dh={Dh}", q, k, v, H)
        if i == 0:
            state["max_abs_err"] = err
            t = {"plain": [], "kernel": []}
            for which in ("plain", "kernel", "kernel", "plain"):
                fn = fa.packed_attention_plain if which == "plain" \
                    else fa.packed_attention_cuda
                t[which].append(cuda_time_ms(lambda: fn(q, k, v, H)))
            state["ms"] = sum(t["kernel"]) / 2
            state["plain_ms"] = sum(t["plain"]) / 2
            gbytes = 2 * (2 * B * Lq * D + 2 * B * Lk * D) / 1e9
            log(f"[kernel] serving shape: kernel {t['kernel']} ms, plain "
                f"{t['plain']} ms (order plain, kernel, kernel, plain); "
                f"kernel moves {gbytes * 1e3:.1f} MB -> "
                f"{gbytes / (state['ms'] / 1e3):.0f} GB/s ({state['smi']})")
    # strided q (a row slice of a wider tensor) and the clamp regime
    B, Lq, Lk, H, Dh = KERNEL_SHAPES[1]
    big, k, v = rand(B, Lk, H * Dh), rand(B, Lk, H * Dh), rand(B, Lk, H * Dh)
    check("strided q (row slice)", big[:, :Lq], k, v, H)
    check("clamp regime (q x 30)", big[:, :Lq] * 30, k, v, H)


# w8a8 kernels against their plain versions: (most outputs that may differ
# at all, most that may differ by more than 2 bf16 ulp, ceiling in units of
# one int8 code flip); see _check_w8a8. Measured on an H100 (NVIDIA H100
# 80GB HBM3, 700.00 W) over the shapes below, worst case: B3 2.0e-5 /
# 2.7e-6 / 0.10; B4 1.3e-3 / 1.5e-4 / 1.31; B5 1.0e-4 / 1.0e-5 / 0.06.
# A B3 that rounds its LayerNorm output to bf16 before the quant gave
# >= 0.58 / 0.20, a B4 that rounds the fp32 attention output to bf16 before
# its quant >= 0.35 / 0.065, a B5 that rounds the hidden to bf16 >= 0.63 /
# 0.21: the share limits sit well above the right kernels and far below
# those.
# B2 has no LayerNorm and no attention sum, so its codes and its epilogue
# are the plain version's exactly: it must match bit for bit.
# The int8 QK^T attention is held to the limits of the kernel it is a form
# of (its integer scores are exact on both sides).
W8A8_LIMITS = {
    "w8a8_matmul": (0.0, 0.0, 0.0),
    "w8a8_matmul3_cat": (1e-3, 1e-4, 2.0),
    "attention_out_int8": (1e-2, 2e-3, 4.0),
    "w8a8_mlp_res": (5e-3, 1e-3, 2.0),
    # the single-source kernel's limits: the two-source entry point must
    # equal that kernel bit for bit on the concatenated keys
    "attention_out_int8_2src": (1e-2, 2e-3, 4.0),
}
# Without the residual the MLP's output is small beside a flip unit, so the
# rare row whose first-stage flip moves the hidden row's absmax (and with it
# every hidden code) shows: measured 2.54 units in one of 25,216 rows, while
# the shares stay where the residual form's are.
W8A8_LIMITS["w8a8_mlp"] = W8A8_LIMITS["w8a8_mlp_res"][:2] + (4.0,)
W8A8_LIMITS["attention_out_int8_qk8"] = W8A8_LIMITS["attention_out_int8"]
# shapes: the serving shape first, then ragged ones (M not a multiple of
# the tile, odd N, K not a multiple of 64, Le = 0, lq < Lkv)
W8A8_MATMUL_SHAPES = ((25088, 768, 768), (37, 768, 77), (45, 100, 33))
W8A8_QKV_SHAPES = ((128, 197, 17, 768, 768), (3, 13, 5, 96, 40),
                   (4, 21, 0, 768, 768), (2, 9, 0, 64, 19))
# (B, lq, Lq rows of q, Lk, H)
W8A8_ATTN_SHAPES = ((128, 197, 214, 214, 12), (3, 13, 21, 21, 2),
                    (2, 77, 77, 150, 4), (2, 40, 100, 100, 12))
# (B, L1, L2, heads) of the two-source form: the serving shape (197 patch
# rows; 8 global + 1 summary + 8 local extras rows), then ragged ones (a
# second source that starts inside a 64-key tile, that fills one exactly,
# of one row)
W8A8_2SRC_SHAPES = ((128, 197, 17, 12), (3, 13, 5, 2), (2, 70, 64, 3),
                    (2, 64, 1, 4))
# (M, K, hidden, N)
W8A8_MLP_SHAPES = ((25216, 768, 3072, 768), (37, 768, 3072, 768),
                   (20, 64, 200, 33))


def _qleaf(gen, K, N, heavy_frac=0.02, heavy_scale=16.0):
    """A w8a8 kernel leaf (int8 weight, fp32 channel scales, the kernels'
    W^T) from a random kernel whose input rows carry the heavy tail of real
    CLIP weights."""
    import torch
    from gava_clip_tpu_torch.ops.int8_matmul import with_kernel_layout
    from gava_clip_tpu_torch.ops.quant import quantize_weight
    w = torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5
    n = max(1, round(K * heavy_frac))
    rows = torch.randperm(K, generator=gen, device="cuda")[:n]
    w[rows] *= heavy_scale
    qa, scale = quantize_weight(w)
    return with_kernel_layout({"qa": qa, "scale": scale})


def _ln_params(gen, K):
    """LayerNorm gain with 4% outlier channels (x8), small bias."""
    import torch
    g = torch.ones(K, device="cuda")
    n = max(1, round(K * 0.04))
    g[torch.randperm(K, generator=gen, device="cuda")[:n]] *= 8.0
    return g, torch.randn(K, generator=gen, device="cuda") * 0.02


def _flip_unit(xs, scale):
    """The most one int8 code flip can move an output: xs * s * 127."""
    return xs * scale.reshape(-1).float() * 127.0


def _check_w8a8(name, out, ref, unit):
    """Hold a w8a8 kernel output against its plain version. Both round the
    same values the same way (the epilogue is the same fp32 sequence); an
    output differs only where an int8 code flipped at a rounding tie (after
    a LayerNorm or attention sum taken in another order), and a flip moves
    it by at most `unit` = xs * s * 127. The ceiling is 2 ulp + k units."""
    import torch
    lim_diff, lim_far, lim_units = W8A8_LIMITS[name]
    err = (out.float() - ref.float()).abs()
    ulp = bf16_ulp(ref)
    diff_share = (err > 0).float().mean().item()
    far_share = (err > 2 * ulp).float().mean().item()
    units = ((err - 2 * ulp).clamp_min(0) / unit.clamp_min(1e-30)).max().item()
    ok = (bool(torch.isfinite(out).all()) and out.shape == ref.shape
          and diff_share <= lim_diff and far_share <= lim_far
          and units <= lim_units)
    return ok, err.max().item(), (
        f"max_abs_err {err.max().item():.3e}; outputs != plain "
        f"{diff_share:.3e} (limit {lim_diff:g}), > 2 bf16 ulp "
        f"{far_share:.3e} (limit {lim_far:g}), max (err - 2 ulp) / flip "
        f"unit {units:.3f} (limit {lim_units:g})")


def phase_w8a8_kernels(state):
    """B2-B5 against their plain versions, at the serving shape and ragged
    ones, with CUDA-event times of both at the serving shape."""
    import torch
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.ops import int8_matmul as im
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16

    def randn(*shape, gain=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * gain).to(bf)

    def run(name, label, kernel, plain, unit, first, bound=None):
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        ok, err, text = _check_w8a8(name, out, ref, unit)
        log(f"[w8a8] {name} {label}: {text} {'ok' if ok else 'FAIL'}")
        if not ok:
            state.setdefault("w8a8_failures", []).append(f"{name} {label}")
        if first:
            t = {"plain": [], "kernel": []}
            for which in ("plain", "kernel", "kernel", "plain"):
                t[which].append(cuda_time_ms(kernel if which == "kernel"
                                             else plain, iters=10))
            # no one PyTorch call computes a w8a8 op: no library time
            state.setdefault("kstats", {})[name] = {
                "max_abs_err": err, "ms": sum(t["kernel"]) / 2,
                "plain_ms": sum(t["plain"]) / 2, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": None}
            log(f"[w8a8] {name} serving shape: kernel {t['kernel']} ms, "
                f"plain {t['plain']} ms, bound {bound[0]:.4f} ms "
                f"({bound[1]}) (order plain, kernel, kernel, plain; "
                f"{state['smi']})")

    for i, (M, K, N) in enumerate(W8A8_MATMUL_SHAPES):
        x = torch.randint(0, 256, (M, K), generator=gen,
                          device="cuda").to(bf)
        kern = _qleaf(gen, K, N)
        b = torch.randn(N, generator=gen, device="cuda") * 0.1
        unit = _flip_unit(im.quant_rows(x.float())[1], kern["scale"])
        run("w8a8_matmul", f"M={M} K={K} N={N}",
            lambda: im.w8a8_matmul_cuda(x, kern, b),
            lambda: im.w8a8_matmul_plain(x, kern, b), unit, i == 0,
            _bound(2 * M * K + K * N + 8 * N + 2 * M * N,
                   ops_int8=2 * M * K * N))

    for i, (B, Lx, Le, K, N) in enumerate(W8A8_QKV_SHAPES):
        x, e = randn(B, Lx, K), (randn(B, Le, K) if Le else None)
        ln = _ln_params(gen, K)
        k3 = [_qleaf(gen, K, N) for _ in range(3)]
        b3 = [torch.randn(N, generator=gen, device="cuda") * 0.02
              for _ in range(3)]
        xs = im.quant_rows(im.ln_f32(im._kv_rows(x, e).float(), *ln))[1]
        unit = torch.cat([_flip_unit(xs, k["scale"]) for k in k3], dim=-1)
        args = (x, e, k3, b3, ln)
        run("w8a8_matmul3_cat", f"B={B} Lx={Lx} Le={Le} K={K} N={N}",
            lambda: torch.cat(im.w8a8_matmul3_cat_cuda(*args), dim=-1),
            lambda: torch.cat(im.w8a8_matmul3_cat_plain(*args), dim=-1),
            unit, i == 0,
            _bound(B * (Lx + Le) * (2 * K + 6 * N) + 3 * K * N + 24 * N
                   + 8 * K, ops_int8=6 * B * (Lx + Le) * K * N))

    for i, (B, lq, Lq, Lk, H) in enumerate(W8A8_ATTN_SHAPES):
        D = H * 64
        q, k, v = randn(B, Lq, D), randn(B, Lk, D), randn(B, Lk, D)
        op = {"kernel": _qleaf(gen, D, D),
              "bias": torch.randn(D, generator=gen, device="cuda") * 0.02}
        r = randn(B, lq, D)
        xs = im.quant_rows(fa._onepass_attention_f32(q[:, :lq], k, v, H))[1]
        unit = _flip_unit(xs, op["kernel"]["scale"])
        run("attention_out_int8", f"B={B} lq={lq} Lq={Lq} Lk={Lk} H={H}",
            lambda: fa.attention_out_int8_cuda(q, k, v, H, op, r, lq),
            lambda: fa.attention_out_int8_plain(q, k, v, H, op, r, lq),
            unit, i == 0,
            # the lq query rows, k, v, the weight, the residual, the output
            _bound(6 * B * lq * D + 4 * B * Lk * D + D * D + 8 * D,
                   flops_bf16=4 * B * lq * Lk * D,
                   ops_int8=2 * B * lq * D * D))

    for i, (M, K, Hd, N) in enumerate(W8A8_MLP_SHAPES):
        x, r = randn(M, K), randn(M, N)
        ln = _ln_params(gen, K)
        fc1 = {"kernel": _qleaf(gen, K, Hd),
               "bias": torch.randn(Hd, generator=gen, device="cuda") * 0.02}
        fc2 = {"kernel": _qleaf(gen, Hd, N),
               "bias": torch.randn(N, generator=gen, device="cuda") * 0.02}
        k1 = fc1["kernel"]
        codes, xs = im.quant_rows(im.ln_f32(x.float(), *ln))
        h = im.quick_gelu_f32(im.rescale(im.int_matmul(codes, k1["qa"]), xs,
                                         k1["scale"], fc1["bias"]))
        unit = _flip_unit(im.quant_rows(h)[1], fc2["kernel"]["scale"])
        del codes, h
        run("w8a8_mlp_res", f"M={M} K={K} H={Hd} N={N}",
            lambda: im.w8a8_mlp_res_cuda(x, fc1, fc2, ln, r),
            lambda: im.w8a8_mlp_res_plain(x, fc1, fc2, ln, r), unit, i == 0,
            _bound(2 * M * K + 4 * M * N + K * Hd + Hd * N
                   + 8 * (Hd + N + K), ops_int8=2 * M * Hd * (K + N)))
    # the two-source form last: the checks above keep their random inputs
    for i, (B, L1, L2, H) in enumerate(W8A8_2SRC_SHAPES):
        D = H * 64
        q, k1, v1, r = (randn(B, L1, D) for _ in range(4))
        k2, v2 = randn(B, L2, D), randn(B, L2, D)
        kc, vc = torch.cat([k1, k2], dim=1), torch.cat([v1, v2], dim=1)
        op = {"kernel": _qleaf(gen, D, D),
              "bias": torch.randn(D, generator=gen, device="cuda") * 0.02}
        xs = im.quant_rows(fa._onepass_attention_f32(q, kc, vc, H))[1]
        unit = _flip_unit(xs, op["kernel"]["scale"])
        args = (q, k1, v1, k2, v2, H, op, r)
        run("attention_out_int8_2src", f"B={B} L1={L1} L2={L2} H={H}",
            lambda: fa.attention_out_int8_2src_cuda(*args),
            lambda: fa.attention_out_int8_2src_plain(*args), unit, i == 0,
            # q, the residual, the output; k1, v1, k2, v2; the weight
            _bound(6 * B * L1 * D + 4 * B * (L1 + L2) * D + D * D + 8 * D,
                   flops_bf16=4 * B * L1 * (L1 + L2) * D,
                   ops_int8=2 * B * L1 * D * D))
        for qk8 in (False, True):
            two = fa.attention_out_int8_2src_cuda(*args, qk8)
            one = fa.attention_out_int8_cuda(q, kc, vc, H, op, r, None, qk8)
            plain = fa.attention_out_int8_2src_plain(*args, qk8)
            torch.cuda.synchronize()
            same = torch.equal(two, one)
            diff = (two != plain).float().mean().item()
            form = "int8 QK^T" if qk8 else "fp32 scores"
            log(f"[w8a8] attention_out_int8_2src B={B} L1={L1} L2={L2} "
                f"H={H}, {form}: equal to the single-source kernel on "
                f"[k1; k2] bit for bit: {same}; outputs != plain {diff:.3e} "
                f"(limit {W8A8_LIMITS['attention_out_int8_2src'][0]:g})")
            if not same or diff > W8A8_LIMITS["attention_out_int8_2src"][0]:
                state.setdefault("w8a8_failures", []).append(
                    f"attention_out_int8_2src B={B} L2={L2} {form}")
        if i == 0:
            t_two = cuda_time_ms(
                lambda: fa.attention_out_int8_2src_cuda(*args))
            t_one = cuda_time_ms(
                lambda: fa.attention_out_int8_cuda(q, kc, vc, H, op, r))
            t_cat = cuda_time_ms(lambda: (torch.cat([k1, k2], dim=1),
                                          torch.cat([v1, v2], dim=1)))
            log(f"[w8a8] attention_out_int8_2src serving shape: {t_two:.4f} "
                f"ms; the single-source kernel on keys concatenated "
                f"beforehand {t_one:.4f} ms, the two concatenations "
                f"{t_cat:.4f} ms ({state['smi']})")
    if state.get("w8a8_failures"):
        raise AssertionError(f"w8a8 kernels disagree with their plain "
                             f"versions: {state['w8a8_failures']}")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def _logits_three_ways(model, params, classnames, xn):
    """Logits of normalized frames xn: bf16 weights with the kernel, bf16
    weights with plain attention, and an fp32 plain-attention reference."""
    import torch
    from gava_clip_tpu_torch.models.vita_clip import VitaClip
    clf = _classifier(model, params, classnames)
    ref32 = VitaClip(model.cfg, _to_device(params, "cuda"),
                     model.text_features.cuda())
    with torch.inference_mode():
        return (clf.net(xn, compute_dtype=torch.bfloat16,
                        attn_impl="flash")["logits"],
                clf.net(xn, compute_dtype=torch.bfloat16,
                        attn_impl="xla")["logits"],
                ref32(xn, compute_dtype=torch.float32,
                      attn_impl="xla")["logits"])


def _classifier(model, params, classnames, **kw):
    from gava_clip_tpu_torch.serve import VideoClassifier
    return VideoClassifier(model, params, classnames, batch_size=16,
                           device="cuda", **kw)


def _check_probs(name, p, n):
    if p.shape != (n, 400) or not np.isfinite(p).all():
        raise AssertionError(f"{name}: bad probabilities {p.shape}")
    err = np.abs(p.sum(-1) - 1.0).max()
    if err > 1e-3:
        raise AssertionError(f"{name}: probabilities sum off by {err}")


def _serving_times(clf, clips, x, iters=10):
    """(clips/s end to end at batch 16, device forward ms, batch-1 latency
    p50 ms)."""
    t0 = time.perf_counter()
    for _ in range(iters):
        clf.classify_clips(clips)
    e2e = 16 * iters / (time.perf_counter() - t0)
    fwd_ms = cuda_time_ms(lambda: clf._forward(x), iters=iters)
    lat = []
    for _ in range(20):
        t1 = time.perf_counter()
        clf.classify_clips(clips[:1])
        lat.append((time.perf_counter() - t1) * 1e3)
    return e2e, fwd_ms, float(np.median(lat))


def phase_slice(state):
    import torch
    from gava_clip_tpu_torch.data.device_preprocess import normalize_frames
    from gava_clip_tpu_torch.data.video import parse_classes_file
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.utils.flagship import (build_zero_shot,
                                                    inject_clip_pathologies)
    _, labels = parse_classes_file(os.path.join(ROOT, "classes",
                                                "k400_classes.txt"))
    t0 = time.perf_counter()
    model = build_zero_shot(num_frames=8, num_classes=400, input_size=224,
                            rng_seed=0)
    params = inject_clip_pathologies(model.param_tree(), seed=0)
    clf = _classifier(model, params, labels)
    assert clf.attn_impl == "flash"
    clf.warmup()
    log(f"[slice] built + warmed up in {time.perf_counter() - t0:.1f} s "
        f"(ViT-B/16, T=8, 224^2, 400 classes, bf16, batch 16)")
    clips = np.random.RandomState(0).randint(0, 256, (16, 8, 224, 224, 3),
                                             dtype=np.uint8)

    fa.reset_launch_counts()
    p16 = clf.classify_clips(clips)
    torch.cuda.synchronize()
    n16 = fa.launch_counts["packed_attention"]
    p5 = clf.classify_clips(clips[:5])
    torch.cuda.synchronize()
    n_all = fa.launch_counts["packed_attention"]
    state["launches"] = n_all
    log(f"[slice] packed_attention launches: {n16} for the 16-clip forward, "
        f"{n_all - n16} for the 5-clip forward (expect 12 each)")
    if (n16, n_all) != (12, 24):
        raise AssertionError("the main path did not launch the kernel once "
                             "per block")
    _check_probs("16 clips", p16, 16)
    _check_probs("5 clips", p5, 5)
    # the 5-clip request pads to the bucket of 8: other GEMM shapes, so
    # only bf16 noise may differ
    d_pad = np.abs(p5 - p16[:5]).max()

    # the same forward with plain attention, and an fp32 reference (fp32
    # weights and activations, plain attention), on the pathology-injected
    # weights and on the plain init. The kernel path and the plain bf16
    # path round differently (fp32 scores and bf16 e vs bf16 q*scale and
    # bf16 probabilities), so neither equals the other bit for bit.
    x = clf._prepare(clips)
    with torch.inference_mode():
        xn = normalize_frames(x, clf._mean, clf._std)
    lg, lg_xla, lg_32 = _logits_three_ways(model, params, labels, xn)
    d_logit = (lg - lg_xla).abs().max().item()
    d_flash = (lg - lg_32).abs().max().item()
    d_xla = (lg_xla - lg_32).abs().max().item()
    log(f"[slice] pathology weights, max |logit diff|: kernel vs plain bf16 "
        f"{d_logit:.4f}, kernel vs fp32 reference {d_flash:.4f}, plain bf16 "
        f"vs fp32 reference {d_xla:.4f} (fp32 logits span "
        f"{lg_32.min().item():.3f}..{lg_32.max().item():.3f}); padded (5 of "
        f"8) vs full batch max |prob diff| {d_pad:.2e}")
    # the outlier gains make the bf16 tower noisy whatever the attention:
    # the kernel path must be as close to fp32 as the plain bf16 path
    if not bool(torch.isfinite(lg).all()) or d_flash > 1.5 * d_xla + 0.01:
        raise AssertionError("the kernel path is farther from the fp32 "
                             "reference than the plain bf16 path")
    if d_pad > 1e-3:
        raise AssertionError("padding a partial batch changed the results")
    lg, lg_xla, lg_32 = _logits_three_ways(model, model.param_tree(), labels,
                                           xn)
    d_plain = (lg - lg_32).abs().max().item()
    log(f"[slice] plain init, max |logit diff|: kernel vs fp32 reference "
        f"{d_plain:.4f}, plain bf16 vs fp32 reference "
        f"{(lg_xla - lg_32).abs().max().item():.4f}")
    # without outliers bf16 tracks fp32 closely: 0.1 logit is 0.7% of
    # exp(logit_scale) = 14.3, a few bf16 ulps of the features
    if d_plain > 0.1:
        raise AssertionError("the kernel path disagrees with the fp32 "
                             "reference on the plain init")

    # throughput at batch 16 (host prep + H2D + forward + D2H) and the
    # device forward alone
    e2e, fwd_ms, lat = _serving_times(clf, clips, x)
    state.update(clf=clf, clips=clips, fwd_ms=fwd_ms, model=model,
                 params=params, labels=labels, p16_bf16=p16,
                 d_logit_bf16_paths=d_logit)
    log(f"[slice] batch 16: {e2e:.1f} clips/s end to end, device forward "
        f"{fwd_ms:.2f} ms = {16e3 / fwd_ms:.1f} clips/s; batch 1 latency p50 "
        f"{lat:.2f} ms ({state['smi']})")


# the w8a8 forward against the same forward with the plain versions of its
# four ops on the card, most |logit diff| allowed: on the plain init, and on
# the pathology weights as a multiple of how far the bf16 kernel path sits
# from the plain bf16 path in the same run (see phase_w8a8_slice)
W8A8_MAX_LOGIT_DIFF_INIT = 0.1
W8A8_PATHOLOGY_FACTOR = 1.5
# the repo's w8a8 accuracy gate: max softmax-prob delta against the bf16
# classifier on the same clips (bench.py)
W8A8_PROB_GATE = 0.05
W8A8_PER_FORWARD = {"w8a8_matmul": 1, "w8a8_matmul3_cat": 12,
                    "attention_out_int8": 12, "w8a8_mlp_res": 12,
                    "packed_attention": 0}


def _launch_counts():
    from gava_clip_tpu_torch.ops import extras_kernel as ek
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.ops import int8_matmul as im
    return {**fa.launch_counts, **im.launch_counts, **ek.launch_counts}


def _reset_launch_counts():
    from gava_clip_tpu_torch.ops import extras_kernel as ek
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.ops import int8_matmul as im
    fa.reset_launch_counts()
    im.reset_launch_counts()
    ek.reset_launch_counts()


def _w8a8_logits(clf, x, impl: str):
    """Logits of uint8 patch rows x through the kernels ('kernel') or the
    plain versions of the same four ops ('plain'), on the card."""
    import torch
    with torch.inference_mode():
        return clf.net(x.to(torch.bfloat16), compute_dtype=torch.bfloat16,
                       attn_impl="flash", input_format="patches",
                       int8_impl=impl)["logits"]


def phase_w8a8_slice(state):
    """The w8a8 + patch-major zero-shot path (ViT-B/16, T=8, 224^2, 400
    classes) at batch 16 on the pathology-injected weights."""
    import torch
    from gava_clip_tpu_torch.data.device_preprocess import normalize_frames
    model, params, labels = state["model"], state["params"], state["labels"]
    clips = state["clips"]
    t0 = time.perf_counter()
    clf = _classifier(model, params, labels, quantize="w8a8",
                      patch_major=True)
    assert clf.attn_impl == "flash"
    clf.warmup()
    log(f"[w8a8-slice] built + warmed up in {time.perf_counter() - t0:.1f}"
        f" s (w8a8 + patch-major, batch 16)")

    _reset_launch_counts()
    p16 = clf.classify_clips(clips)
    torch.cuda.synchronize()
    n16 = _launch_counts()
    p5 = clf.classify_clips(clips[:5])
    torch.cuda.synchronize()
    n_all = _launch_counts()
    state["launches_w8a8"] = n_all
    log(f"[w8a8-slice] launches for the 16-clip forward {n16}, after the "
        f"5-clip forward {n_all} (expect {W8A8_PER_FORWARD} per forward)")
    for name, per in W8A8_PER_FORWARD.items():
        if (n16[name], n_all[name]) != (per, 2 * per):
            raise AssertionError(f"{name}: {n16[name]} / {n_all[name]} "
                                 f"launches, expected {per} per forward")
    _check_probs("16 clips", p16, 16)
    _check_probs("5 clips", p5, 5)
    d_pad = np.abs(p5 - p16[:5]).max()
    if d_pad > 1e-3:
        raise AssertionError("padding a partial batch changed the results")

    # kernels vs the plain versions of the same four ops, on the pathology
    # weights and on the plain init
    x = clf._prepare(clips)
    lg, lg_plain = (_w8a8_logits(clf, x, i) for i in ("kernel", "plain"))
    d_path = (lg - lg_plain).abs().max().item()
    init_clf = _classifier(model, model.param_tree(), labels,
                           quantize="w8a8", patch_major=True)
    lg_i, lg_i_plain = (_w8a8_logits(init_clf, x, i)
                        for i in ("kernel", "plain"))
    d_init = (lg_i - lg_i_plain).abs().max().item()
    del init_clf
    # the repo's gate: prob delta against the bf16 classifier
    bf16 = state["clf"]
    with torch.inference_mode():
        xn = normalize_frames(bf16._prepare(clips), bf16._mean, bf16._std)
        lg_bf16 = bf16.net(xn, compute_dtype=torch.bfloat16,
                           attn_impl="flash")["logits"]
    d_prob = np.abs(p16 - state["p16_bf16"]).max()
    d_logit_bf16 = (lg - lg_bf16).abs().max().item()
    state["w8a8_accuracy"] = dict(d_path=d_path, d_init=d_init,
                                  d_prob=d_prob, d_logit_bf16=d_logit_bf16,
                                  d_pad=d_pad)
    # A code flipped at a rounding tie (another LayerNorm or attention sum
    # order) moves one row by one int8 step; the random 12-block tower
    # amplifies such steps on the pathology weights (x8 LN gains, x16
    # kernel rows) as it amplifies bf16 rounding, so there the w8a8 kernels
    # may sit no farther from their plain versions than the bf16 kernel sits
    # from plain bf16 attention (x1.5); on the plain init both stay close.
    lim_path = W8A8_PATHOLOGY_FACTOR * state["d_logit_bf16_paths"]
    log(f"[w8a8-slice] max |logit diff| kernels vs plain versions: "
        f"pathology weights {d_path:.4f} (limit {lim_path:.4f} = "
        f"{W8A8_PATHOLOGY_FACTOR} x the bf16 kernel-vs-plain "
        f"{state['d_logit_bf16_paths']:.4f}), plain init {d_init:.4f} "
        f"(limit {W8A8_MAX_LOGIT_DIFF_INIT}); logits span "
        f"{lg_plain.min().item():.3f}..{lg_plain.max().item():.3f}; padded "
        f"(5 of 8) vs full batch max |prob diff| {d_pad:.2e}")
    log(f"[w8a8-slice] gate vs the bf16 classifier: max |prob diff| "
        f"{d_prob:.4e} (limit {W8A8_PROB_GATE}), max |logit diff| "
        f"{d_logit_bf16:.4f}")
    if not bool(torch.isfinite(lg).all()) or d_path > lim_path or \
            d_init > W8A8_MAX_LOGIT_DIFF_INIT:
        raise AssertionError("the w8a8 kernels' forward disagrees with the "
                             "plain versions' forward")
    if d_prob > W8A8_PROB_GATE:
        raise AssertionError("the w8a8 forward fails the prob-delta gate")

    e2e, fwd_ms, lat = _serving_times(clf, clips, x)
    plain_ms = cuda_time_ms(lambda: _w8a8_logits(clf, x, "plain"), iters=3,
                            warmup=1)
    state.update(clf_w8a8=clf, fwd_ms_w8a8=fwd_ms)
    log(f"[w8a8-slice] batch 16: {e2e:.1f} clips/s end to end, device "
        f"forward {fwd_ms:.2f} ms = {16e3 / fwd_ms:.1f} clips/s (bf16 path "
        f"{state['fwd_ms']:.2f} ms; the forward through the plain versions "
        f"{plain_ms:.2f} ms); batch 1 latency p50 {lat:.2f} ms "
        f"({state['smi']})")


# (B, Lq, Lk, heads): the two training shapes of the packed kernels first
# (16 clips x 8 frames; 4 clips x 70 frames: 197 query tokens, 197 + 8
# global + 1 summary + T local keys), then ragged ones
TRAIN_PACKED_SHAPES = ((128, 197, 214, 12), (280, 197, 276, 12),
                       (3, 13, 21, 2), (2, 77, 150, 4), (2, 65, 64, 3))
# (B, Lq, Lk, heads, causal): the text tower's shape first (15 prompts x 77
# tokens, 8 heads), then a longer causal L, non-causal keys beyond the
# packed kernel's 640, and ragged cross shapes
TRAIN_STREAM_SHAPES = ((15, 77, 77, 8, True), (4, 1024, 1024, 8, True),
                       (2, 130, 700, 2, False), (3, 13, 21, 2, False),
                       (2, 100, 60, 2, True), (2, 200, 200, 3, True))
# Limits of the training kernels against their plain versions: (most
# outputs that may differ at all, most that may differ by more than 2 bf16
# ulp + the floor, and the ceiling's factor k in err <= 2 ulp + k * 2^-8 *
# bound). Both versions round each weight (e or p), each ds and each output
# to bf16 at the same points, so they differ only where an fp32 sum taken
# in another order lands next to a rounding boundary; one flipped rounding
# moves one term of a sum by 2^-8 of itself. bound is sum p|v| for a
# forward (exact: the plain version on |v|) and the largest |gradient| of
# the tensor for a backward (a term of a gradient sum is at most of that
# order). The streaming forward rescales by a running max, so the bf16
# rounding of p falls at another point than in its plain version (which
# knows the final max): there most outputs may differ by an ulp, and only
# the far share and the ceiling are held. Measured on an H100 (NVIDIA H100
# 80GB HBM3, 700.00 W), worst over the shapes above: packed forward 3.9e-4
# / 3.6e-5, den exact in all but 2.3e-3 of the rows, packed backward 6.4e-4
# / 5.8e-5; streaming forward 3.4e-1 / 5.7e-2, streaming backward 6.3e-3 /
# 6.2e-3 (all of it gradients that cancel to ~1e-7 of the tensor's scale,
# below the floor of 2^-16 of the largest |gradient|).
TRAIN_LIMITS = {
    "packed_attention_den": (5e-3, 1e-3, 1.0),
    "packed_attention_bwd": (5e-3, 1e-3, 2.0),
    "packed_attention_bwd_recompute": (5e-3, 1e-3, 2.0),
    "streaming_attention": (1.0, 1.5e-1, 1.0),
    "streaming_attention_bwd": (5e-2, 5e-3, 2.0),
}
# den: the sum of at most 640 bf16 values in fp32 is exact in most rows
# whatever the order; a kernel that sums the unrounded e moves every row
# The recompute backward against the saved-residual backward's own output:
# the two differ in one rounding (delta from the fp32 output instead of its
# bf16 rounding), which moves delta by up to 2^-9 of sum |do * o| and with
# it about a fifth of the bf16 values of ds; held as a relative L2 distance
# per gradient (measured 2e-3 .. 4e-3 on an H100)
RECOMPUTE_VS_SAVED_MAX_REL_L2 = 2e-2
MAX_DEN_DIFF_SHARE = 2e-2
MAX_DEN_REL_ERR = 2.0 ** -8
H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_INT8_OPS = 1979e12
H100_FP32_FLOPS = 67e12


def _bound(n_bytes, flops_bf16=0.0, ops_int8=0.0, flops_fp32=0.0):
    """(bound_ms, bound_by): the larger of the bytes over the card's memory
    rate and the operations over the card's peak rate for their type
    (H100 SXM data sheet)."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = (flops_bf16 / H100_BF16_FLOPS + ops_int8 / H100_INT8_OPS
             + flops_fp32 / H100_FP32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _visible_pairs(Lq, Lk, causal):
    """Score entries that the mask leaves visible."""
    if not causal:
        return Lq * Lk
    return sum(min(i + 1, Lk) for i in range(Lq))


def _attention_bounds(B, Lq, Lk, H, causal=False):
    """Bounds of the four attention functions at one shape: forward (with
    and without the fp32 row statistic) and backward."""
    D = H * 64
    pairs = B * H * _visible_pairs(Lq, Lk, causal)
    qo, kv, stat = 2 * B * Lq * D, 2 * B * Lk * D, 4 * B * Lq * H
    return {
        "fwd": _bound(2 * qo + 2 * kv, 2 * 2 * 64 * pairs),
        "fwd_stat": _bound(2 * qo + 2 * kv + stat, 2 * 2 * 64 * pairs),
        # reads q, do, o, k, v and the statistic, writes dq, dk, dv; five
        # products per score entry
        "bwd": _bound(4 * qo + 4 * kv + stat, 5 * 2 * 64 * pairs),
        # reads q, do, k, v, writes dq, dk, dv; the forward's two products
        # and the backward's four per score entry
        "bwd_recompute": _bound(3 * qo + 4 * kv, 6 * 2 * 64 * pairs),
    }


def _sdpa_times(q, k, v, do, H, causal):
    """F.scaled_dot_product_attention on the same inputs, forward and
    backward apart (a yardstick only: the port never calls it)."""
    import torch
    import torch.nn.functional as F
    B, Lq, D = q.shape

    def heads(x):
        return x.view(B, x.shape[1], H, D // H).transpose(1, 2)

    qh, kh, vh = (heads(x).detach().requires_grad_() for x in (q, k, v))
    doh = heads(do)
    with torch.no_grad():
        fwd = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal))
    out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
    bwd = cuda_time_ms(lambda: torch.autograd.grad(
        out, (qh, kh, vh), doh, retain_graph=True))
    return fwd, bwd


def _check_train(name, label, out, ref, bound, state, hold_diff=True):
    import torch
    lim_diff, lim_far, k = TRAIN_LIMITS[name]
    if not hold_diff:
        lim_diff = 1.0
    err = (out.float() - ref.float()).abs()
    ulp = bf16_ulp(ref)
    floor = 2.0 ** -16 * ref.float().abs().max()
    ceiling = 2 * ulp + k * 2.0 ** -8 * bound + floor
    diff_share = (err > 0).float().mean().item()
    far_share = (err > 2 * ulp + floor).float().mean().item()
    ok = (out.shape == ref.shape and bool(torch.isfinite(out.float()).all())
          and diff_share <= lim_diff and far_share <= lim_far
          and bool((err <= ceiling).all()))
    log(f"[train-kernel] {name} {label}: max_abs_err {err.max().item():.3e}; "
        f"outputs != plain {diff_share:.3e} (limit {lim_diff:g}), > 2 bf16 "
        f"ulp {far_share:.3e} (limit {lim_far:g}); max err/ceiling "
        f"{(err / ceiling).max().item():.3f} {'ok' if ok else 'FAIL'}")
    if not ok:
        state.setdefault("train_failures", []).append(f"{name} {label}")
    return err.max().item()


def _time_pair(kernel, plain, iters=10):
    t = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        t[which].append(cuda_time_ms(kernel if which == "kernel" else plain,
                                     iters=iters))
    return sum(t["kernel"]) / 2, sum(t["plain"]) / 2, t


def phase_train_kernels(state):
    """B6a, B6b and B7 (forward and backward) against their plain versions
    on the card, at the training shapes and ragged ones; CUDA-event times of
    kernel, plain version and F.scaled_dot_product_attention at the
    training shapes."""
    import torch
    from gava_clip_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    def absmax(ts):
        return [t.float().abs().max() for t in ts]

    stats = state.setdefault("kstats", {})
    for i, (B, Lq, Lk, H) in enumerate(TRAIN_PACKED_SHAPES):
        D = H * 64
        label = f"B={B} Lq={Lq} Lk={Lk} H={H}"
        q, k, v, do = rand(B, Lq, D), rand(B, Lk, D), rand(B, Lk, D), \
            rand(B, Lq, D)
        out, den = fa.packed_attention_den_cuda(q, k, v, H)
        ref, den_ref = fa.packed_attention_den_plain(q, k, v, H)
        torch.cuda.synchronize()
        spread = fa.packed_attention_plain(q, k, v.abs(), H).float()
        err_f = _check_train("packed_attention_den", label, out, ref, spread,
                             state)
        den_err = (den - den_ref).abs()
        den_share = (den_err > 0).float().mean().item()
        den_rel = (den_err / den_ref).max().item()
        den_ok = den.shape == den_ref.shape and \
            den_share <= MAX_DEN_DIFF_SHARE and den_rel <= MAX_DEN_REL_ERR
        log(f"[train-kernel] packed_attention_den {label}: den rows != plain "
            f"{den_share:.3e} (limit {MAX_DEN_DIFF_SHARE:g}), max relative "
            f"error {den_rel:.3e} (limit 2^-8) {'ok' if den_ok else 'FAIL'}")
        if not den_ok:
            state.setdefault("train_failures", []).append(f"den {label}")
        # the backward on the plain forward's residuals, so that only the
        # backward kernel is under test
        grads = fa.packed_attention_bwd_cuda(q, k, v, do, ref, den_ref, H)
        g_ref = fa.packed_attention_bwd_plain(q, k, v, do, ref, den_ref, H)
        torch.cuda.synchronize()
        err_b = max(_check_train("packed_attention_bwd", f"{label} {n}", g, r,
                                 m, state)
                    for n, g, r, m in zip(("dq", "dk", "dv"), grads, g_ref,
                                          absmax(g_ref)))
        # the backward that takes q, k, v, do alone: against its plain
        # version, and against the saved-residual kernel's output
        g8 = fa.packed_attention_bwd_recompute_cuda(q, k, v, do, H)
        g8_ref = fa.packed_attention_bwd_recompute_plain(q, k, v, do, H)
        torch.cuda.synchronize()
        err_8 = max(_check_train("packed_attention_bwd_recompute",
                                 f"{label} {n}", g, r, m, state)
                    for n, g, r, m in zip(("dq", "dk", "dv"), g8, g8_ref,
                                          absmax(g8_ref)))
        rel = [((a.float() - b.float()).norm()
                / b.float().norm().clamp_min(1e-30)).item()
               for a, b in zip(g8, grads)]
        share = [(a != b).float().mean().item() for a, b in zip(g8, grads)]
        rel_ok = max(rel) <= RECOMPUTE_VS_SAVED_MAX_REL_L2
        log(f"[train-kernel] packed_attention_bwd_recompute {label}: vs the "
            f"saved-residual kernel's dq, dk, dv: relative L2 "
            f"{[f'{x:.2e}' for x in rel]} (limit "
            f"{RECOMPUTE_VS_SAVED_MAX_REL_L2:g}), outputs that differ "
            f"{[f'{x:.2e}' for x in share]} {'ok' if rel_ok else 'FAIL'}")
        if not rel_ok:
            state.setdefault("train_failures", []).append(
                f"recompute vs saved {label}")
        del spread, grads, g_ref, g8, g8_ref
        if i < 2:
            ms_8, plain_8, t_8 = _time_pair(
                lambda: fa.packed_attention_bwd_recompute_cuda(q, k, v, do,
                                                               H),
                lambda: fa.packed_attention_bwd_recompute_plain(q, k, v, do,
                                                                H), iters=5)
            ms_f, plain_f, t_f = _time_pair(
                lambda: fa.packed_attention_den_cuda(q, k, v, H),
                lambda: fa.packed_attention_den_plain(q, k, v, H))
            ms_b, plain_b, t_b = _time_pair(
                lambda: fa.packed_attention_bwd_cuda(q, k, v, do, ref,
                                                     den_ref, H),
                lambda: fa.packed_attention_bwd_plain(q, k, v, do, ref,
                                                      den_ref, H), iters=5)
            lib_f, lib_b = _sdpa_times(q, k, v, do, H, False)
            bounds = _attention_bounds(B, Lq, Lk, H)
            log(f"[train-kernel] {label}: B6a kernel {t_f['kernel']} ms, "
                f"plain {t_f['plain']} ms, SDPA forward {lib_f:.4f} ms, bound "
                f"{bounds['fwd_stat'][0]:.4f} ms ({bounds['fwd_stat'][1]}); "
                f"B6b kernel {t_b['kernel']} ms, plain {t_b['plain']} ms, "
                f"SDPA backward {lib_b:.4f} ms, bound {bounds['bwd'][0]:.4f} "
                f"ms ({bounds['bwd'][1]}); B8 kernel {t_8['kernel']} ms, "
                f"plain {t_8['plain']} ms, bound "
                f"{bounds['bwd_recompute'][0]:.4f} ms "
                f"({bounds['bwd_recompute'][1]}) (order plain, kernel, "
                f"kernel, plain; {state['smi']})")
            if i == 0:
                for name, err, ms, plain, lib, key in (
                        ("packed_attention_den", err_f, ms_f, plain_f, lib_f,
                         "fwd_stat"),
                        ("packed_attention_bwd", err_b, ms_b, plain_b, lib_b,
                         "bwd"),
                        ("packed_attention_bwd_recompute", err_8, ms_8,
                         plain_8, lib_b, "bwd_recompute")):
                    stats[name] = {
                        "max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
                        "library_ms": lib}
                # B1 shares this shape: its bound and its yardstick
                state["b1_bound"] = bounds["fwd"]
                state["b1_library_ms"] = lib_f

    for i, (B, Lq, Lk, H, causal) in enumerate(TRAIN_STREAM_SHAPES):
        D = H * 64
        label = f"B={B} Lq={Lq} Lk={Lk} H={H} causal={causal}"
        q, k, v, do = rand(B, Lq, D), rand(B, Lk, D), rand(B, Lk, D), \
            rand(B, Lq, D)
        out, lse = fa.streaming_attention_cuda(q, k, v, H, causal)
        ref, lse_ref = fa.streaming_attention_plain(q, k, v, H, causal)
        torch.cuda.synchronize()
        spread = fa.streaming_attention_plain(q, k, v.abs(), H,
                                              causal)[0].float()
        err_f = _check_train("streaming_attention", label, out, ref, spread,
                             state)
        lse_err = (lse - lse_ref).abs().max().item()
        # fp32 log-sum-exp of O(1..10): sums in another order
        lse_ok = lse.shape == lse_ref.shape and lse_err <= 1e-4
        log(f"[train-kernel] streaming_attention {label}: max |lse - plain| "
            f"{lse_err:.3e} (limit 1e-4) {'ok' if lse_ok else 'FAIL'}")
        if not lse_ok:
            state.setdefault("train_failures", []).append(f"lse {label}")
        grads = fa.streaming_attention_bwd_cuda(q, k, v, do, ref, lse_ref, H,
                                                causal)
        g_ref = fa.streaming_attention_bwd_plain(q, k, v, do, ref, lse_ref,
                                                 H, causal)
        torch.cuda.synchronize()
        err_b = max(_check_train("streaming_attention_bwd", f"{label} {n}", g,
                                 r, m, state)
                    for n, g, r, m in zip(("dq", "dk", "dv"), grads, g_ref,
                                          absmax(g_ref)))
        del spread, grads, g_ref
        if i < 2:
            ms_f, plain_f, t_f = _time_pair(
                lambda: fa.streaming_attention_cuda(q, k, v, H, causal),
                lambda: fa.streaming_attention_plain(q, k, v, H, causal))
            ms_b, plain_b, t_b = _time_pair(
                lambda: fa.streaming_attention_bwd_cuda(q, k, v, do, ref,
                                                        lse_ref, H, causal),
                lambda: fa.streaming_attention_bwd_plain(q, k, v, do, ref,
                                                         lse_ref, H, causal))
            lib_f, lib_b = _sdpa_times(q, k, v, do, H, causal)
            bounds = _attention_bounds(B, Lq, Lk, H, causal)
            log(f"[train-kernel] {label}: B7 forward kernel {t_f['kernel']} "
                f"ms, plain {t_f['plain']} ms, SDPA forward {lib_f:.4f} ms, "
                f"bound {bounds['fwd_stat'][0]:.5f} ms "
                f"({bounds['fwd_stat'][1]}); B7 backward kernel "
                f"{t_b['kernel']} ms, plain {t_b['plain']} ms, SDPA backward "
                f"{lib_b:.4f} ms, bound {bounds['bwd'][0]:.5f} ms "
                f"({bounds['bwd'][1]}) ({state['smi']})")
            if i == 0:
                for name, err, ms, plain, lib, key in (
                        ("streaming_attention", err_f, ms_f, plain_f, lib_f,
                         "fwd_stat"),
                        ("streaming_attention_bwd", err_b, ms_b, plain_b,
                         lib_b, "bwd")):
                    stats[name] = {
                        "max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
                        "library_ms": lib}
    # the clamp regime of the packed backward. There the softmax is nearly
    # one-hot and dq, dk cancel to ~1e-7 of dv's scale: fp32 noise decides
    # their bits, so only the far share and the ceiling are held
    B, Lq, Lk, H = TRAIN_PACKED_SHAPES[2]
    q, k, v, do = (rand(B, L, H * 64) for L in (Lq, Lk, Lk, Lq))
    q = q * 30
    ref, den_ref = fa.packed_attention_den_plain(q, k, v, H)
    grads = fa.packed_attention_bwd_cuda(q, k, v, do, ref, den_ref, H)
    g_ref = fa.packed_attention_bwd_plain(q, k, v, do, ref, den_ref, H)
    torch.cuda.synchronize()
    for n, g, r, m in zip(("dq", "dk", "dv"), grads, g_ref, absmax(g_ref)):
        _check_train("packed_attention_bwd", f"clamp regime (q x 30) {n}", g,
                     r, m, state, hold_diff=False)
    g8 = fa.packed_attention_bwd_recompute_cuda(q, k, v, do, H)
    g8_ref = fa.packed_attention_bwd_recompute_plain(q, k, v, do, H)
    torch.cuda.synchronize()
    for n, g, r, m in zip(("dq", "dk", "dv"), g8, g8_ref, absmax(g8_ref)):
        _check_train("packed_attention_bwd_recompute",
                     f"clamp regime (q x 30) {n}", g, r, m, state,
                     hold_diff=False)
    if state.get("train_failures"):
        raise AssertionError(f"training kernels disagree with their plain "
                             f"versions: {state['train_failures']}")


# launches of the attention kernels in one training step of the flagship
# model: 12 vision blocks (B6a forward, B6b backward) and 12 text blocks
# (B7 forward and backward); the forward that writes no denominators (B1)
# is not on this path
TRAIN_PER_STEP = {"packed_attention_den": 12, "packed_attention_bwd": 12,
                  "streaming_attention": 12, "streaming_attention_bwd": 12,
                  "packed_attention": 0}
TRAIN_STEPS = 6
# the first step through the kernels against the same step through the
# plain versions on the card: the two differ by single bf16 roundings in a
# share of ~5e-4 of the attention outputs (limits above), which 12 bf16
# blocks carry on. Measured on an H100 (NVIDIA H100 80GB HBM3, 700.00 W):
# loss 1.650962 vs 1.651374; relative L2 error of a gradient leaf 2.4e-4 in
# the median and 3.8e-2 at most (a leaf whose own norm is small); a wrong
# backward moves a leaf by its whole norm.
TRAIN_MAX_LOSS_DIFF = 2e-2
TRAIN_MAX_GRAD_REL_ERR = 1e-1


def _train_batch(B, T, seed=0):
    """The JAX bench's batch (bench.py main_train): seeded numpy inputs."""
    import torch
    rs = np.random.RandomState(seed)
    batch = {"video": rs.rand(B, T, 224, 224, 3).astype(np.float32),
             "labels": rs.randint(0, 3, size=B),
             "nte": rs.randn(B, 70, 512).astype(np.float32),
             "memory": rs.randn(64, 4, 512).astype(np.float32),
             "mt_labels": rs.randint(0, 3, size=64)}
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def _grad_list(state_tree):
    from gava_clip_tpu_torch.train.state import tree_leaves
    return [p.grad.detach().float().clone() for p in tree_leaves(state_tree)
            if p is not None]


def _named_leaves(tree, prefix=""):
    """(path, tensor) of every leaf that is not a None placeholder."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _named_leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _named_leaves(v, f"{prefix}{i}.")]
    return [] if tree is None else [(prefix[:-1], tree)]


def phase_train_slice(state):
    """The training step at full width: build_flagship -> trainable_mask ->
    create_train_state -> make_train_step -> steps on a fixed batch."""
    import torch
    from gava_clip_tpu_torch.models.vita_clip import trainable_mask
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.train.state import (create_train_state,
                                                 make_optimizer, tree_leaves)
    from gava_clip_tpu_torch.train.step import (LossConfig, make_loss_fn,
                                                make_train_step)
    from gava_clip_tpu_torch.utils.flagship import build_flagship
    loss_cfg = LossConfig(num_classes=3, focal_ordinal=True, fo_beta=0.2,
                          use_support_memory=True, add_nte=True)
    # the bench's schedule with a larger rate (the JAX bench's 5e-6 moves a
    # weight by less than one bf16 ulp in 6 steps: no loss could show it)
    opt = make_optimizer(lr=1e-3, num_steps=2000, weight_decay=0.2)
    kw = dict(compute_dtype=torch.bfloat16, attn_impl="flash")

    t0 = time.perf_counter()
    model = build_flagship(num_frames=8)          # on the card
    mask = trainable_mask(model.params, model.cfg)
    ts = create_train_state(model.params, mask, opt)
    n_train = sum(p.numel() for p in tree_leaves(ts.trainable)
                  if p is not None)
    n_frozen = sum(p.numel() for p in tree_leaves(ts.frozen)
                   if p is not None)
    batch = _train_batch(16, 8)
    log(f"[train-slice] built in {time.perf_counter() - t0:.1f} s (ViT-B/16 "
        f"T=8 224^2 + text 12 x 512 + KAPT over 5 versions + memory + NTE "
        f"heads; {n_train / 1e6:.2f} M trainable, {n_frozen / 1e6:.2f} M "
        f"frozen parameters; batch 16 clips, bf16, remat none)")
    if any(p.requires_grad for p in tree_leaves(ts.frozen) if p is not None):
        raise AssertionError("a frozen leaf requires a gradient")

    # the first step's loss and gradients through the plain versions
    loss_fn = make_loss_fn(model, loss_cfg, remat="none", **kw)
    with fa.plain_versions():
        total_plain, _ = loss_fn(ts.trainable, ts.frozen, batch)
        total_plain.backward()
    g_plain = _grad_list(ts.trainable)
    ts.optimizer.zero_grad(set_to_none=True)
    _reset_launch_counts()
    total_k, _ = loss_fn(ts.trainable, ts.frozen, batch)
    total_k.backward()
    torch.cuda.synchronize()
    if any(_launch_counts()[n] != TRAIN_PER_STEP[n] for n in TRAIN_PER_STEP):
        raise AssertionError(f"launches of one loss + backward "
                             f"{_launch_counts()}, expected {TRAIN_PER_STEP}")
    g_kernel = _grad_list(ts.trainable)
    ts.optimizer.zero_grad(set_to_none=True)
    d_loss = abs(total_k.item() - total_plain.item())
    scale = max(g.norm().item() for g in g_plain)
    rel = [((a - b).norm() / b.norm().clamp_min(1e-3 * scale)).item()
           for a, b in zip(g_kernel, g_plain)]
    worst = [n for n, _ in _named_leaves(ts.trainable)][int(np.argmax(rel))]
    log(f"[train-slice] first step, kernels vs plain versions on the card: "
        f"total {total_k.item():.6f} vs {total_plain.item():.6f} (diff "
        f"{d_loss:.2e}, limit {TRAIN_MAX_LOSS_DIFF:g}); gradient leaves "
        f"{len(rel)}, max relative L2 error {max(rel):.3e} ({worst}), median "
        f"{float(np.median(rel)):.3e} (limit {TRAIN_MAX_GRAD_REL_ERR:g})")
    if not all(bool(torch.isfinite(g).all()) for g in g_kernel) or \
            d_loss > TRAIN_MAX_LOSS_DIFF or max(rel) > TRAIN_MAX_GRAD_REL_ERR:
        raise AssertionError("the training step through the kernels "
                             "disagrees with the plain versions")
    del g_plain, g_kernel

    step = make_train_step(model, loss_cfg, opt, remat="none", **kw)
    names_t = [n for n, _ in _named_leaves(ts.trainable)]
    before_t = [p.detach().clone() for _, p in _named_leaves(ts.trainable)]
    frozen = [p for p in tree_leaves(ts.frozen) if p is not None]
    before_f = [p.detach().clone() for p in frozen]
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    totals, host_ms, events = [], [], []
    for _ in range(TRAIN_STEPS):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        t1 = time.perf_counter()
        ev[0].record()
        ts, metrics = step(ts, batch)
        ev[1].record()
        totals.append(metrics["total"].item())     # waits for the step
        host_ms.append((time.perf_counter() - t1) * 1e3)
        events.append(ev)
    torch.cuda.synchronize()
    counts = _launch_counts()
    state["launches_train"] = counts
    dev_ms = [a.elapsed_time(b) for a, b in events]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train-slice] {TRAIN_STEPS} steps on a fixed batch: total loss "
        f"{[round(t, 4) for t in totals]}; last metrics "
        f"{ {k: round(v.item(), 4) for k, v in metrics.items()} }")
    log(f"[train-slice] launches over {TRAIN_STEPS} steps {counts} (expect "
        f"{TRAIN_PER_STEP} per step)")
    for name, per in TRAIN_PER_STEP.items():
        if counts[name] != per * TRAIN_STEPS:
            raise AssertionError(f"{name}: {counts[name]} launches, expected "
                                 f"{per} per step")
    if not all(np.isfinite(totals)) or not totals[-1] < totals[0]:
        raise AssertionError(f"the total loss did not fall: {totals}")
    if ts.step != TRAIN_STEPS:
        raise AssertionError(f"state.step {ts.step}")
    after_t = [p for _, p in _named_leaves(ts.trainable)]
    if not all(torch.equal(a, b) for a, b in zip(frozen, before_f)):
        raise AssertionError("a frozen leaf changed")
    # The knowledge projector's two layers are both zero-initialised, as in
    # the JAX package: each blocks the other's gradient, so they (and only
    # they) stay at zero. Every other trainable leaf must have moved.
    stuck = [n for n, a, b in zip(names_t, after_t, before_t)
             if torch.equal(a, b)]
    if sorted(stuck) != ["prompt.projector.w1", "prompt.projector.w2"] or \
            any(bool(ts.trainable["prompt"]["projector"][w].any())
                for w in ("w1", "w2")):
        raise AssertionError(f"trainable leaves that did not move: {stuck}")
    if len(ts.optimizer.state) != len(after_t):
        raise AssertionError("optimizer state for other than the trainable "
                             "leaves")
    log(f"[train-slice] {len(after_t) - 2} of {len(after_t)} trainable "
        f"leaves moved (the zero-initialised projector pair stays at zero), "
        f"{len(frozen)} frozen leaves bit-unchanged and without optimizer "
        f"state; step time by CUDA events {np.median(dev_ms[1:]):.2f} ms "
        f"median of {[round(t, 1) for t in dev_ms]}, by host clock "
        f"{np.median(host_ms[1:]):.2f} ms; {16e3 / np.median(host_ms[1:]):.1f}"
        f" clips/s; peak memory {peak:.2f} GiB ({state['smi']})")
    state.update(train_step=step, train_state=ts, train_batch=batch,
                 train_loss_fn=loss_fn,
                 train_ms=float(np.median(dev_ms[1:])))


TRAIN_LONG_STEPS = 3


def phase_train_long(state):
    """Steps at the JAX bench's shape (bench.py main_train): 4 clips of 70
    frames, remat='full': every block's forward runs twice."""
    import torch
    from gava_clip_tpu_torch.models.vita_clip import trainable_mask
    from gava_clip_tpu_torch.train.state import (create_train_state,
                                                 make_optimizer)
    from gava_clip_tpu_torch.train.step import LossConfig, make_train_step
    from gava_clip_tpu_torch.utils.flagship import build_flagship
    for key in ("train_step", "train_state", "train_batch", "train_loss_fn"):
        state.pop(key, None)
    torch.cuda.empty_cache()
    loss_cfg = LossConfig(num_classes=3, focal_ordinal=True, fo_beta=0.2,
                          use_support_memory=True, add_nte=True)
    opt = make_optimizer(lr=5e-6, num_steps=2000, weight_decay=0.2)
    model = build_flagship(num_frames=70)
    ts = create_train_state(model.params,
                            trainable_mask(model.params, model.cfg), opt)
    step = make_train_step(model, loss_cfg, opt, remat="full",
                           compute_dtype=torch.bfloat16, attn_impl="flash")
    batch = _train_batch(4, 70)
    ts, metrics = step(ts, batch)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    dev_ms, host_ms = [], []
    for _ in range(TRAIN_LONG_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        ts, metrics = step(ts, batch)
        end.record()
        total = metrics["total"].item()            # waits for the step
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    counts = _launch_counts()
    want = {n: per * TRAIN_LONG_STEPS for n, per in
            dict(TRAIN_PER_STEP, packed_attention_den=24).items()}
    log(f"[train-long] B=4 T=70 (280 frame rows, Lk 276), bf16, remat full, "
        f"{TRAIN_LONG_STEPS} steps: total {total:.4f}; launches {counts} "
        f"(expect {want}); step by CUDA events "
        f"{[round(t, 1) for t in dev_ms]} ms (median "
        f"{np.median(dev_ms):.2f}), by host clock "
        f"{[round(t, 1) for t in host_ms]} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
        f"({state['smi']})")
    if not np.isfinite(total) or any(counts[n] != want[n] for n in want):
        raise AssertionError("the long-clip step failed its checks")


# ---------------------------------------------------------------------------
# the remaining serving modes: w8, fused prompt extras, int8 QK^T, the
# residual-free w8a8 MLP
# ---------------------------------------------------------------------------

# The w8 GEMM against its plain version: (most outputs that may differ at
# all, most that may differ by more than 2 bf16 ulp, the ceiling's factor k
# in err <= 2 ulp + k * (|x| @ |w|)). Both dequantize each weight with one
# rounding and round each output once; only the order of the fp32 sums
# differs, which moves an output across a bf16 rounding boundary in a small
# share of elements, and by more than 2 ulp only where a sum cancels to
# near zero: there the error stays within fp32 accumulation noise of the
# sum of the terms' magnitudes. A kernel that rounds the scale to bf16
# before the product moves most weights by a bf16 ulp and so most outputs.
W8_LIMITS = (5e-3, 1e-3, 2e-5)
# (M, K, N): the projections of one block at batch 16 (q and out; k and v
# over the 214 kv rows; fc1; fc2), then ragged ones (K no multiple of 8: the
# element-wise loads; K a multiple of 8 but not of 16, ragged M and N)
W8_MATMUL_SHAPES = ((25216, 768, 768, "q / out"), (27392, 768, 768, "k / v"),
                    (25216, 768, 3072, "fc1"), (25216, 3072, 768, "fc2"),
                    (37, 100, 33, "ragged"), (300, 776, 130, "ragged"))
# The fused extras against their plain version: fp32 arithmetic on both
# sides, sums in another order. fp32 outputs within EXTRAS_TOL * max(1,
# max |plain|); bf16 outputs (each the rounding of such an fp32 value) equal
# in all but a share EXTRAS_MAX_DIFF_SHARE, and then one bf16 ulp apart. A
# kernel that rounds cls_proj to bf16 as the stock branch does moves every
# later value by up to 2^-9 of itself, most bf16 outputs with it.
EXTRAS_TOL = 2e-5
EXTRAS_MAX_DIFF_SHARE = 5e-3
# (Bb, Tb, D, heads, G, le_pad, activations, weights, LayerNorm gain,
# tolerance factor)
EXTRAS_SHAPES = ((16, 8, 768, 12, 8, 17, "bf16", "fp32", 1.0, 1),
                 (16, 8, 768, 12, 8, 24, "bf16", "bf16", 1.0, 1),
                 (16, 8, 768, 12, 8, 17, "fp32", "fp32", 1.0, 1),
                 (3, 3, 40, 2, 2, 8, "fp32", "fp32", 1.0, 1),
                 (2, 5, 64, 4, 3, 9, "bf16", "bf16", 1.0, 1),
                 # scores of ~1e3, far beyond a one-pass clamp: the exact
                 # softmax. The fp32 noise of such a score (~1e-4) moves an
                 # unsaturated probability by as much of itself, so the
                 # tolerance is 1e3 times wider; a clamped softmax is off
                 # by the outputs' own size, 1e4 times the tolerance
                 (4, 8, 768, 12, 8, 17, "fp32", "fp32", 40.0, 1000))
# the int8 QK^T form against the fp32-score form of the same kernel, at the
# JAX test's input statistics (tests/test_flash_attention.py
# test_int8_qk_scores_close_to_fp32, which holds 5e-3 at D = 64 in fp32).
# Here D = 256 (the kernel's head dim is 64) and the outputs are bf16, so
# the check is on the whole tensor: the relative L2 distance, measured
# against the attention's contribution (output minus residual), and the
# largest |diff| against the largest |output|. The plain versions give
# 6.0e-3..6.7e-3 and 0.8e-2..1.1e-2 over five seeds.
INT8_QK_LOOSE_L2 = 2e-2
INT8_QK_LOOSE_MAX = 3e-2


def _w8_leaf(gen, K, N):
    """A weight-only kernel leaf {'q', 'scale', 'q_t'} (heavy-tailed rows)."""
    leaf = _qleaf(gen, K, N)
    return {"q": leaf["qa"], "scale": leaf["scale"], "q_t": leaf["qa_t"]}


def _record(state, name, err, ms, plain_ms, bound, library_ms):
    state.setdefault("kstats", {})[name] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms}


def _w8_matmul_checks(state, gen):
    import torch
    from gava_clip_tpu_torch.ops import int8_matmul as im
    lim_diff, lim_far, k_ceiling = W8_LIMITS
    for M, K, N, what in W8_MATMUL_SHAPES:
        x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
        leaf = _w8_leaf(gen, K, N)
        out = im.int8_matmul_cuda(x, leaf)
        ref = im.int8_matmul_plain(x, leaf["q"], leaf["scale"])
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        ulp = bf16_ulp(ref)
        w = im.dequant_weight(leaf["q"], leaf["scale"], x.dtype)
        spread = x.float().abs() @ w.float().abs()
        ceiling = 2 * ulp + k_ceiling * spread
        diff_share = (err > 0).float().mean().item()
        far_share = (err > 2 * ulp).float().mean().item()
        ok = (out.shape == ref.shape and bool(torch.isfinite(out).all())
              and diff_share <= lim_diff and far_share <= lim_far
              and bool((err <= ceiling).all()))
        log(f"[w8-kernel] int8_matmul {what} M={M} K={K} N={N}: max_abs_err "
            f"{err.max().item():.3e}; outputs != plain {diff_share:.3e} "
            f"(limit {lim_diff:g}), > 2 bf16 ulp {far_share:.3e} (limit "
            f"{lim_far:g}); max err/ceiling {(err / ceiling).max().item():.3f}"
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            state.setdefault("w8_failures", []).append(f"int8_matmul {what}")
        del spread, ceiling, ulp
        if what == "ragged":
            continue
        ms, plain_ms, t = _time_pair(
            lambda: im.int8_matmul_cuda(x, leaf),
            lambda: im.int8_matmul_plain(x, leaf["q"], leaf["scale"]))
        # the one PyTorch call that computes the same function (a yardstick
        # only: the port never calls it)
        lib = cuda_time_ms(lambda: torch.matmul(
            x, (leaf["q"].float() * leaf["scale"]).to(x.dtype)), iters=10)
        bound = _bound(2 * M * K + K * N + 4 * N + 2 * M * N,
                       flops_bf16=2 * M * K * N)
        log(f"[w8-kernel] int8_matmul {what}: kernel {t['kernel']} ms "
            f"({2e-9 * M * K * N / ms:.0f} TFLOP/s), plain {t['plain']} ms, "
            f"torch.matmul on the dequantized weight {lib:.4f} ms, bound "
            f"{bound[0]:.4f} ms ({bound[1]}) (order plain, kernel, kernel, "
            f"plain; {state['smi']})")
        if what == "fc1":
            _record(state, "int8_matmul", err.max().item(), ms, plain_ms,
                    bound, lib)


def _w8a8_mlp_checks(state, gen):
    """B5a at the tower's shape with and without the LayerNorm, and a ragged
    shape; and the qkv kernel with no extras rows (B3a), timed."""
    import torch
    from gava_clip_tpu_torch.ops import int8_matmul as im
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(bf)

    def bias(n):
        return torch.randn(n, generator=gen, device="cuda") * 0.02

    for i, (M, K, Hd, N, with_ln) in enumerate((
            (25216, 768, 3072, 768, True), (25216, 768, 3072, 768, False),
            (37, 768, 3072, 768, True), (20, 64, 200, 33, False))):
        x = randn(M, K)
        ln = _ln_params(gen, K) if with_ln else None
        fc1 = {"kernel": _qleaf(gen, K, Hd), "bias": bias(Hd)}
        fc2 = {"kernel": _qleaf(gen, Hd, N), "bias": bias(N)}
        x32 = x.float() if ln is None else im.ln_f32(x.float(), *ln)
        codes, xs = im.quant_rows(x32)
        k1 = fc1["kernel"]
        h = im.quick_gelu_f32(im.rescale(im.int_matmul(codes, k1["qa"]), xs,
                                         k1["scale"], fc1["bias"]))
        unit = _flip_unit(im.quant_rows(h)[1], fc2["kernel"]["scale"])
        del codes, h, x32
        out = im.w8a8_mlp_cuda(x, fc1, fc2, ln)
        ref = im.w8a8_mlp_plain(x, fc1, fc2, ln)
        torch.cuda.synchronize()
        ok, err, text = _check_w8a8("w8a8_mlp", out, ref, unit)
        label = f"M={M} K={K} H={Hd} N={N} ln={'yes' if with_ln else 'none'}"
        log(f"[w8-kernel] w8a8_mlp {label}: {text} {'ok' if ok else 'FAIL'}")
        if not ok:
            state.setdefault("w8_failures", []).append(f"w8a8_mlp {label}")
        if i < 2:
            ms, plain_ms, t = _time_pair(
                lambda: im.w8a8_mlp_cuda(x, fc1, fc2, ln),
                lambda: im.w8a8_mlp_plain(x, fc1, fc2, ln), iters=5)
            bound = _bound(2 * M * K + 2 * M * N + K * Hd + Hd * N
                           + 8 * (Hd + N + K), ops_int8=2 * M * Hd * (K + N))
            log(f"[w8-kernel] w8a8_mlp {label}: kernel {t['kernel']} ms, "
                f"plain {t['plain']} ms, bound {bound[0]:.4f} ms "
                f"({bound[1]}) (order plain, kernel, kernel, plain; "
                f"{state['smi']})")
            if i == 0:
                # no one PyTorch call computes a w8a8 op: no library time
                _record(state, "w8a8_mlp", err, ms, plain_ms, bound, None)

    # the qkv kernel with no extras rows (the TPU's _w8a8_kernel3) at the
    # tower's shape: checked at Le = 0 in the w8a8-kernel phase, timed here
    B, Lx, K, N = 128, 197, 768, 768
    x, ln = randn(B, Lx, K), _ln_params(gen, K)
    k3 = [_qleaf(gen, K, N) for _ in range(3)]
    b3 = [bias(N) for _ in range(3)]
    ms, plain_ms, t = _time_pair(
        lambda: im.w8a8_matmul3_cat_cuda(x, None, k3, b3, ln),
        lambda: im.w8a8_matmul3_cat_plain(x, None, k3, b3, ln))
    bound = _bound(B * Lx * (2 * K + 6 * N) + 3 * K * N + 24 * N + 8 * K,
                   ops_int8=6 * B * Lx * K * N)
    log(f"[w8-kernel] w8a8_matmul3_cat with no extras rows (Le = 0) B={B} "
        f"Lx={Lx} K={K} N={N}: kernel {t['kernel']} ms, plain {t['plain']} "
        f"ms, bound {bound[0]:.4f} ms ({bound[1]}), no library call, 0 "
        f"launches on a main path ({state['smi']})")


def _extras_params(gen, Tb, D, G, wdtype, ln_gain):
    """A block's prompt-branch params as the w8a8 classifier holds them
    (fp32) or as a caller that cast its tree would (bf16 weights)."""
    import torch

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    def lin():
        return {"kernel": randn(D, D, std=D ** -0.5).to(wdtype),
                "bias": randn(D, std=0.02)}

    p = {"cls_proj": lin(),
         "summary_ln": {"scale": (1 + 0.1 * randn(D)) * ln_gain,
                        "bias": randn(D, std=0.02)},
         "summary_attn": {n: lin() for n in ("q", "k", "v", "out")},
         "local_prompts": randn(1, Tb, D, std=0.05)}
    return p, randn(G, D, std=0.05)


def _fused_extras_checks(state, gen):
    import torch
    from gava_clip_tpu_torch.models.vision import VisionConfig, prompt_extras
    from gava_clip_tpu_torch.ops import extras_kernel as ek
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}
    for i, (Bb, Tb, D, H, G, le_pad, act, wd, gain, tol_factor) in enumerate(
            EXTRAS_SHAPES):
        tol = EXTRAS_TOL * tol_factor
        BT = Bb * Tb
        p, gp = _extras_params(gen, Tb, D, G, dt[wd], gain)
        # the cls rows as the tower hands them over: a strided view
        x = (torch.randn(BT, 5, D, generator=gen, device="cuda")
             ).to(dt[act])
        cls = x[:, 0]
        kw = dict(Tb=Tb, num_heads=H, le_pad=le_pad)
        e, summ = ek.fused_extras_cuda(cls, p, gp, **kw)
        e_ref, summ_ref = ek.fused_extras_plain(cls, p, gp, **kw)
        torch.cuda.synchronize()
        le = G + 1 + Tb
        oks, texts, worst = [], [], 0.0
        for name, out, ref in (("e", e, e_ref), ("summary", summ, summ_ref)):
            err = (out.float() - ref.float()).abs()
            scale = max(1.0, ref.float().abs().max().item())
            worst = max(worst, err.max().item())
            if act == "fp32":
                ok = bool((err <= tol * scale).all())
                texts.append(f"{name} max_abs_err {err.max().item():.3e} "
                             f"(limit {tol * scale:.1e})")
            else:
                share = (err > 0).float().mean().item()
                ok = share <= EXTRAS_MAX_DIFF_SHARE and bool(
                    (err <= bf16_ulp(ref) + tol * scale).all())
                texts.append(f"{name} max_abs_err {err.max().item():.3e}, "
                             f"outputs != plain {share:.3e} (limit "
                             f"{EXTRAS_MAX_DIFF_SHARE:g})")
            oks.append(ok and out.shape == ref.shape and out.dtype == dt[act]
                       and bool(torch.isfinite(out.float()).all()))
        # the rows that are copies: global prompts and zero pad rows
        oks.append(bool((e[:, le:] == 0).all()) and torch.equal(
            e[:, :G], gp.to(dt[act])[None].expand(BT, G, D)))
        label = (f"Bb={Bb} Tb={Tb} D={D} H={H} G={G} le_pad={le_pad} "
                 f"activations {act} weights {wd} LN gain {gain:g}")
        log(f"[w8-kernel] fused_extras {label}: {'; '.join(texts)}; pad rows "
            f"zero and global rows exact: {oks[-1]} "
            f"{'ok' if all(oks) else 'FAIL'}")
        if not all(oks):
            state.setdefault("w8_failures", []).append(f"fused_extras {label}")
        if i >= 2:
            continue
        # the stock ops that the fused launch replaces, on the same inputs,
        # in the activations' dtype (the yardstick of this row)
        cfg = VisionConfig(num_frames=Tb, feature_dim=D, heads=H,
                           use_summary_token=True, use_local_prompts=True,
                           use_global_prompts=True, num_global_prompts=G)

        def stock():
            extras, s_ = prompt_extras(p, gp, x, cfg)
            return torch.cat(extras, dim=1), s_

        ms, plain_ms, t = _time_pair(
            lambda: ek.fused_extras_cuda(cls, p, gp, **kw),
            lambda: ek.fused_extras_plain(cls, p, gp, **kw), iters=20)
        stock_ms = cuda_time_ms(stock, iters=20)
        d_stock = (stock()[0].float() - e_ref[:, :le].float()).abs().max()
        wb, ab = (2 if wd == "bf16" else 4), (2 if act == "bf16" else 4)
        bound = _bound(5 * D * D * wb + BT * D * ab * 2
                       + BT * le_pad * D * ab + 4 * (7 + Tb + G) * D,
                       flops_fp32=2 * 5 * BT * D * D
                       + 4 * Bb * Tb * Tb * D)
        log(f"[w8-kernel] fused_extras {label}: kernel {t['kernel']} ms, "
            f"plain {t['plain']} ms, the stock ops it replaces (with the "
            f"concatenation) {stock_ms:.4f} ms, bound {bound[0]:.4f} ms "
            f"({bound[1]}); stock ops vs the fp32 arithmetic max |diff| "
            f"{d_stock.item():.3e} (order plain, kernel, kernel, plain; "
            f"{state['smi']})")
        if i == 0:
            _record(state, "fused_extras", worst, ms, plain_ms, bound,
                    stock_ms)


def _int8_qk_checks(state, gen):
    import torch
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.ops import int8_matmul as im
    bf = torch.bfloat16

    def randn(*shape, gain=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * gain).to(bf)

    name = "attention_out_int8_qk8"
    for i, (B, lq, Lq, Lk, H) in enumerate(W8A8_ATTN_SHAPES):
        D = H * 64
        q, k, v = randn(B, Lq, D), randn(B, Lk, D), randn(B, Lk, D)
        op = {"kernel": _qleaf(gen, D, D),
              "bias": torch.randn(D, generator=gen, device="cuda") * 0.02}
        r = randn(B, lq, D)
        xs = im.quant_rows(fa._onepass_attention_den_f32(
            q[:, :lq], k, v, H, int8_qk=True)[0])[1]
        unit = _flip_unit(xs, op["kernel"]["scale"])
        out = fa.attention_out_int8_cuda(q, k, v, H, op, r, lq, True)
        ref = fa.attention_out_int8_plain(q, k, v, H, op, r, lq, True)
        torch.cuda.synchronize()
        ok, err, text = _check_w8a8(name, out, ref, unit)
        label = f"B={B} lq={lq} Lq={Lq} Lk={Lk} H={H}"
        log(f"[w8-kernel] {name} {label}: {text} {'ok' if ok else 'FAIL'}")
        if not ok:
            state.setdefault("w8_failures", []).append(f"{name} {label}")
        if i == 0:
            t = {"plain": [], "int8": [], "fp32": []}
            fns = {"plain": lambda: fa.attention_out_int8_plain(
                       q, k, v, H, op, r, lq, True),
                   "int8": lambda: fa.attention_out_int8_cuda(
                       q, k, v, H, op, r, lq, True),
                   "fp32": lambda: fa.attention_out_int8_cuda(
                       q, k, v, H, op, r, lq, False)}
            for which in ("plain", "fp32", "int8", "int8", "fp32", "plain"):
                t[which].append(cuda_time_ms(fns[which], iters=10))
            bound = _bound(6 * B * lq * D + 4 * B * Lk * D + D * D + 8 * D,
                           flops_bf16=2 * B * lq * Lk * D,
                           ops_int8=2 * B * lq * Lk * D + 2 * B * lq * D * D)
            log(f"[w8-kernel] {name} serving shape: kernel {t['int8']} ms, "
                f"the fp32-score form of the same kernel {t['fp32']} ms, "
                f"plain {t['plain']} ms, bound {bound[0]:.4f} ms "
                f"({bound[1]}) (order plain, fp32, int8, int8, fp32, plain; "
                f"{state['smi']})")
            _record(state, name, err, sum(t["int8"]) / 2,
                    sum(t["plain"]) / 2, bound, None)
    # the loose check against the fp32-score form
    B, Lq, Lk, H = 3, 30, 38, 4
    D = H * 64
    q, k = randn(B, Lq, D, gain=0.3), randn(B, Lk, D, gain=0.3)
    v, r = randn(B, Lk, D, gain=0.1), randn(B, Lq, D, gain=0.1)
    from gava_clip_tpu_torch.ops.int8_matmul import with_kernel_layout
    op = {"kernel": with_kernel_layout({
        "qa": torch.randint(-127, 127, (D, D), generator=gen,
                            device="cuda").to(torch.int8),
        "scale": torch.randn(1, D, generator=gen, device="cuda").abs()
        * 0.01}),
        "bias": torch.randn(D, generator=gen, device="cuda") * 0.01}
    got = fa.attention_out_int8_cuda(q, k, v, H, op, r, None, True).float()
    want = fa.attention_out_int8_cuda(q, k, v, H, op, r, None, False).float()
    diff = (got - want).abs()
    rel_l2 = (diff.norm() / (want - r.float()).norm()).item()
    rel_max = (diff.max() / want.abs().max().clamp_min(1.0)).item()
    ok = rel_l2 <= INT8_QK_LOOSE_L2 and rel_max <= INT8_QK_LOOSE_MAX and \
        diff.max().item() > 0
    log(f"[w8-kernel] {name} vs the fp32-score form (B={B} Lq={Lq} Lk={Lk} "
        f"H={H}, q, k x 0.3): relative L2 of the diff against the "
        f"attention's contribution {rel_l2:.3e} (limit "
        f"{INT8_QK_LOOSE_L2:g}), max |diff| / max |output| {rel_max:.3e} "
        f"(limit {INT8_QK_LOOSE_MAX:g}); the switch changes the result: "
        f"{diff.max().item() > 0} {'ok' if ok else 'FAIL'}")
    if not ok:
        state.setdefault("w8_failures", []).append(f"{name} loose check")


def phase_w8_kernels(state):
    """B9, B5a, B10 and B11 against their plain versions on the card."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(3)
    _w8_matmul_checks(state, gen)
    _w8a8_mlp_checks(state, gen)
    _fused_extras_checks(state, gen)
    _int8_qk_checks(state, gen)
    if state.get("w8_failures"):
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{state['w8_failures']}")


W8_PER_FORWARD = {"int8_matmul": 72, "packed_attention": 12,
                  "w8a8_matmul": 0, "w8a8_mlp_res": 0}
# The w8 forward is held to the same forward through the plain versions of
# its GEMM and its attention as the w8a8 slice is (W8A8_MAX_LOGIT_DIFF_INIT
# on the plain init, W8A8_PATHOLOGY_FACTOR on the pathology weights), and to
# the bf16 forward by the prob gate and this multiple of the bf16
# kernel-vs-plain logit distance (measured 1.35 against 1.58 on an H100).
W8_BF16_FACTOR = 2.0


def _w8_logits(clf, xn, plain: bool):
    import contextlib
    import torch
    from gava_clip_tpu_torch.ops import flash_attention as fa
    with torch.inference_mode(), \
            (fa.plain_versions() if plain else contextlib.nullcontext()):
        return clf.net(xn, compute_dtype=torch.bfloat16, attn_impl="flash",
                       int8_impl="plain" if plain else "kernel")["logits"]


def phase_w8_slice(state):
    """The weight-only int8 zero-shot path (ViT-B/16, T=8, 224^2, 400
    classes) at batch 16 on the pathology-injected weights, and
    mlp_block(residual=None) on w8a8 leaves at the tower's shape."""
    import torch
    from gava_clip_tpu_torch.data.device_preprocess import normalize_frames
    model, params, labels = state["model"], state["params"], state["labels"]
    clips = state["clips"]
    t0 = time.perf_counter()
    clf = _classifier(model, params, labels, quantize="w8")
    assert clf.attn_impl == "flash" and clf.quantize == "w8"
    clf.warmup()
    log(f"[w8-slice] built + warmed up in {time.perf_counter() - t0:.1f} s "
        f"(w8, batch 16)")
    _reset_launch_counts()
    p16 = clf.classify_clips(clips)
    torch.cuda.synchronize()
    n16 = _launch_counts()
    p5 = clf.classify_clips(clips[:5])
    torch.cuda.synchronize()
    n_all = _launch_counts()
    state.setdefault("launches_by_kernel", {})["int8_matmul"] = \
        n_all["int8_matmul"]
    log(f"[w8-slice] launches for the 16-clip forward {n16}, after the "
        f"5-clip forward {n_all} (expect {W8_PER_FORWARD} per forward)")
    for name, per in W8_PER_FORWARD.items():
        if (n16[name], n_all[name]) != (per, 2 * per):
            raise AssertionError(f"{name}: {n16[name]} / {n_all[name]} "
                                 f"launches, expected {per} per forward")
    _check_probs("16 clips", p16, 16)
    _check_probs("5 clips", p5, 5)
    d_pad = np.abs(p5 - p16[:5]).max()
    if d_pad > 1e-3:
        raise AssertionError("padding a partial batch changed the results")

    x = clf._prepare(clips)
    with torch.inference_mode():
        xn = normalize_frames(x, clf._mean, clf._std)
    lg, lg_plain = _w8_logits(clf, xn, False), _w8_logits(clf, xn, True)
    d_path = (lg - lg_plain).abs().max().item()
    init_clf = _classifier(model, model.param_tree(), labels, quantize="w8")
    d_init = (_w8_logits(init_clf, xn, False)
              - _w8_logits(init_clf, xn, True)).abs().max().item()
    del init_clf
    bf16 = state["clf"]
    with torch.inference_mode():
        lg_bf16 = bf16.net(xn, compute_dtype=torch.bfloat16,
                           attn_impl="flash")["logits"]
    d_prob = np.abs(p16 - state["p16_bf16"]).max()
    d_logit_bf16 = (lg - lg_bf16).abs().max().item()
    lim_path = W8A8_PATHOLOGY_FACTOR * state["d_logit_bf16_paths"]
    log(f"[w8-slice] max |logit diff| kernels vs plain versions: pathology "
        f"weights {d_path:.4f} (limit {lim_path:.4f} = {W8A8_PATHOLOGY_FACTOR}"
        f" x the bf16 kernel-vs-plain {state['d_logit_bf16_paths']:.4f}), "
        f"plain init {d_init:.4f} (limit {W8A8_MAX_LOGIT_DIFF_INIT}); padded "
        f"(5 of 8) vs full batch max |prob diff| {d_pad:.2e}")
    # int8 weights move the logits as far from bf16 as rounding paths move
    # them on these weights: within twice the bf16 kernel-vs-plain distance
    lim_bf16 = W8_BF16_FACTOR * state["d_logit_bf16_paths"]
    log(f"[w8-slice] gate vs the bf16 classifier: max |prob diff| "
        f"{d_prob:.4e} (limit {W8A8_PROB_GATE}), max |logit diff| "
        f"{d_logit_bf16:.4f} (limit {lim_bf16:.4f} = {W8_BF16_FACTOR} x the "
        f"bf16 kernel-vs-plain)")
    if not bool(torch.isfinite(lg).all()) or d_path > lim_path or \
            d_init > W8A8_MAX_LOGIT_DIFF_INIT:
        raise AssertionError("the w8 kernels' forward disagrees with the "
                             "plain versions' forward")
    if d_prob > W8A8_PROB_GATE or d_logit_bf16 > lim_bf16:
        raise AssertionError("the w8 forward is too far from the bf16 one")

    # patch-major + w8: the embed is the float GEMM on the folded kernel
    # (no int8 sidecar without activation quant), the blocks are the same
    pm = _classifier(model, params, labels, quantize="w8", patch_major=True)
    _reset_launch_counts()
    p_pm = pm.classify_clips(clips)
    torch.cuda.synchronize()
    n_pm = _launch_counts()
    _check_probs("patch-major", p_pm, 16)
    # another rounding path through the embed (raw uint8 rows against the
    # folded fp32 kernel cast to bf16), which the pathology weights amplify
    # as they amplify every rounding: held to the repo's gate
    d_pm = np.abs(p_pm - p16).max()
    d_pm_bf16 = np.abs(p_pm - state["p16_bf16"]).max()
    log(f"[w8-slice] w8 + patch-major: launches {n_pm['int8_matmul']} "
        f"int8_matmul, {n_pm['w8a8_matmul']} w8a8_matmul (expect 72, 0); "
        f"max |prob diff| vs the frames-input w8 classifier {d_pm:.3e}, vs "
        f"the bf16 classifier {d_pm_bf16:.4e} (limit {W8A8_PROB_GATE})")
    if (n_pm["int8_matmul"], n_pm["w8a8_matmul"]) != (72, 0) or \
            d_pm_bf16 > W8A8_PROB_GATE:
        raise AssertionError("the patch-major w8 classifier failed")
    del pm

    e2e, fwd_ms, lat = _serving_times(clf, clips, x)
    plain_ms = cuda_time_ms(lambda: _w8_logits(clf, xn, True), iters=3,
                            warmup=1)
    state.update(clf_w8=clf, fwd_ms_w8=fwd_ms)
    log(f"[w8-slice] batch 16: {e2e:.1f} clips/s end to end, device forward "
        f"{fwd_ms:.2f} ms = {16e3 / fwd_ms:.1f} clips/s (bf16 path "
        f"{state['fwd_ms']:.2f} ms; the forward through the plain versions "
        f"{plain_ms:.2f} ms); batch 1 latency p50 {lat:.2f} ms "
        f"({state['smi']})")

    # B5a's path: an MLP block called without a residual on w8a8 leaves, at
    # the tower's shape, through ops.linear.mlp_block
    from gava_clip_tpu_torch.ops.activations import quick_gelu
    from gava_clip_tpu_torch.ops.linear import mlp_block
    blk = state["clf_w8a8"].net.visual.blocks[0]
    xb = torch.randn(128, 197, 768, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(4)
                     ).to(torch.bfloat16)
    _reset_launch_counts()
    with torch.inference_mode():
        y = mlp_block(blk["mlp"], blk["norm2"], xb, quick_gelu)
        y_plain = mlp_block(blk["mlp"], blk["norm2"], xb, quick_gelu,
                            int8_impl="plain")
        y_res = mlp_block(blk["mlp"], blk["norm2"], xb, quick_gelu,
                          residual=xb)
    torch.cuda.synchronize()
    n = _launch_counts()
    state["launches_by_kernel"]["w8a8_mlp"] = n["w8a8_mlp"]
    d = (y.float() - y_plain.float()).abs().max().item()
    # with the residual the same block is x + y, rounded once more
    d_res = (y_res.float() - (xb.float() + y.float())).abs()
    ok = (y.shape == xb.shape and bool(torch.isfinite(y).all())
          and n["w8a8_mlp"] == 1 and n["w8a8_mlp_res"] == 1
          and (y != y_plain).float().mean().item()
          <= W8A8_LIMITS["w8a8_mlp"][0]
          and bool((d_res <= bf16_ulp(y_res) + bf16_ulp(y)).all()))
    log(f"[w8-slice] mlp_block(residual=None) on the first block's w8a8 "
        f"leaves, (128, 197, 768): launches {n['w8a8_mlp']} w8a8_mlp / "
        f"{n['w8a8_mlp_res']} w8a8_mlp_res (expect 1 / 1), max |diff| vs "
        f"the plain version {d:.3e}, the residual form minus (x + y) at "
        f"most {(d_res / (bf16_ulp(y_res) + bf16_ulp(y))).max().item():.2f} "
        f"of one bf16 ulp of each {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("mlp_block(residual=None) failed its checks")

    # the two-source attention's path: its public entry point on the first
    # block's out-projection at the serving shape, keys from two arrays
    from gava_clip_tpu_torch.ops import flash_attention as fa
    g4 = torch.Generator(device="cuda").manual_seed(6)
    q, k1, v1 = (torch.randn(128, 197, 768, device="cuda", generator=g4
                             ).to(torch.bfloat16) for _ in range(3))
    k2, v2 = (torch.randn(128, 17, 768, device="cuda", generator=g4
                          ).to(torch.bfloat16) for _ in range(2))
    _reset_launch_counts()
    with torch.inference_mode():
        y2 = fa.flash_attention_out_int8_2src(q, k1, v1, k2, v2, 12,
                                              blk["attn"]["out"], xb)
        n = _launch_counts()
        y1 = fa.flash_attention_out_int8(
            q, torch.cat([k1, k2], dim=1), torch.cat([v1, v2], dim=1), 12,
            blk["attn"]["out"], xb)
        y2_plain = fa.flash_attention_out_int8_2src(
            q, k1, v1, k2, v2, 12, blk["attn"]["out"], xb, impl="plain")
    torch.cuda.synchronize()
    state["launches_by_kernel"]["attention_out_int8_2src"] = \
        n["attention_out_int8_2src"]
    diff = (y2 != y2_plain).float().mean().item()
    ok = (n["attention_out_int8_2src"] == 1 and n["attention_out_int8"] == 0
          and y2.shape == xb.shape and bool(torch.isfinite(y2).all())
          and torch.equal(y2, y1)
          and diff <= W8A8_LIMITS["attention_out_int8_2src"][0])
    log(f"[w8-slice] flash_attention_out_int8_2src on the first block's "
        f"out-projection, q / k1 / v1 (128, 197, 768), k2 / v2 (128, 17, "
        f"768): launches {n['attention_out_int8_2src']} (expect 1), equal to "
        f"flash_attention_out_int8 on the concatenation bit for bit: "
        f"{torch.equal(y2, y1)}, outputs != plain {diff:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_attention_out_int8_2src failed its checks")


VARIANT_PER_FORWARD = {
    "fused": {"fused_extras": 12, "w8a8_matmul": 1, "w8a8_matmul3_cat": 12,
              "attention_out_int8": 12, "attention_out_int8_qk8": 0,
              "w8a8_mlp_res": 12},
    "fused + int8 QK^T": {"fused_extras": 12, "w8a8_matmul": 1,
                          "w8a8_matmul3_cat": 12, "attention_out_int8": 0,
                          "attention_out_int8_qk8": 12, "w8a8_mlp_res": 12},
}
# The fused extras replace bf16 stock ops by fp32 arithmetic: the extras
# rows move by bf16 roundings, which the tower carries on as it carries the
# roundings of the two bf16 attention paths; so the fused forward may sit as
# far from the unfused one as those sit from each other (x1.5), and within
# the plain-init limit of the w8a8 slice on the plain init. The int8 QK^T
# forward is held to its own plain-version forward the same way.


def phase_w8a8_variants(state):
    """The w8a8 + patch-major classifier with the fused prompt extras, then
    with the int8 QK^T scores as well."""
    import torch
    from gava_clip_tpu_torch.ops import extras_kernel as ek
    from gava_clip_tpu_torch.ops import flash_attention as fa
    clf, clips = state["clf_w8a8"], state["clips"]
    model, labels = state["model"], state["labels"]
    x = clf._prepare(clips)
    init_clf = _classifier(model, model.param_tree(), labels,
                           quantize="w8a8", patch_major=True)
    lim_path = W8A8_PATHOLOGY_FACTOR * state["d_logit_bf16_paths"]
    base = _w8a8_logits(clf, x, "kernel")
    base_init = _w8a8_logits(init_clf, x, "kernel")
    try:
        for variant, int8_qk in (("fused", False),
                                 ("fused + int8 QK^T", True)):
            ek.set_fused_extras(True)
            fa.set_int8_qk(int8_qk)
            clf.warmup()
            _reset_launch_counts()
            p16 = clf.classify_clips(clips)
            torch.cuda.synchronize()
            n16 = _launch_counts()
            p5 = clf.classify_clips(clips[:5])
            torch.cuda.synchronize()
            n_all = _launch_counts()
            per = VARIANT_PER_FORWARD[variant]
            log(f"[w8a8-variants] {variant}: launches for the 16-clip "
                f"forward {n16}, after the 5-clip forward {n_all} (expect "
                f"{per} per forward)")
            for name, want in per.items():
                if (n16[name], n_all[name]) != (want, 2 * want):
                    raise AssertionError(
                        f"{variant}: {name} {n16[name]} / {n_all[name]} "
                        f"launches, expected {want} per forward")
            by_kernel = state.setdefault("launches_by_kernel", {})
            by_kernel["fused_extras"] = by_kernel.get("fused_extras", 0) \
                + n_all["fused_extras"]
            if int8_qk:
                by_kernel["attention_out_int8_qk8"] = \
                    n_all["attention_out_int8_qk8"]
            _check_probs(f"{variant}, 16 clips", p16, 16)
            _check_probs(f"{variant}, 5 clips", p5, 5)
            d_pad = np.abs(p5 - p16[:5]).max()
            lg, lg_plain = (_w8a8_logits(clf, x, i)
                            for i in ("kernel", "plain"))
            d_path = (lg - lg_plain).abs().max().item()
            d_init = (_w8a8_logits(init_clf, x, "kernel")
                      - _w8a8_logits(init_clf, x, "plain")).abs().max().item()
            d_base = (lg - base).abs().max().item()
            d_base_init = (_w8a8_logits(init_clf, x, "kernel")
                           - base_init).abs().max().item()
            d_prob = np.abs(p16 - state["p16_bf16"]).max()
            log(f"[w8a8-variants] {variant}: max |logit diff| kernels vs "
                f"plain versions: pathology weights {d_path:.4f} (limit "
                f"{lim_path:.4f}), plain init {d_init:.4f} (limit "
                f"{W8A8_MAX_LOGIT_DIFF_INIT}); vs the unfused w8a8 forward: "
                f"pathology weights {d_base:.4f} (limit {lim_path:.4f}), "
                f"plain init {d_base_init:.4f} (limit "
                f"{W8A8_MAX_LOGIT_DIFF_INIT}); gate vs the bf16 classifier "
                f"max |prob diff| {d_prob:.4e} (limit {W8A8_PROB_GATE}); "
                f"padded vs full batch {d_pad:.2e}")
            if not bool(torch.isfinite(lg).all()) or d_path > lim_path or \
                    d_init > W8A8_MAX_LOGIT_DIFF_INIT or d_pad > 1e-3:
                raise AssertionError(f"{variant}: the kernels' forward "
                                     f"disagrees with the plain versions'")
            if d_base > lim_path or d_base_init > W8A8_MAX_LOGIT_DIFF_INIT:
                raise AssertionError(f"{variant}: too far from the unfused "
                                     f"w8a8 forward")
            if d_prob > W8A8_PROB_GATE:
                raise AssertionError(f"{variant}: fails the prob-delta gate")
            e2e, fwd_ms, lat = _serving_times(clf, clips, x)
            log(f"[w8a8-variants] {variant}, batch 16: {e2e:.1f} clips/s end "
                f"to end, device forward {fwd_ms:.2f} ms = "
                f"{16e3 / fwd_ms:.1f} clips/s (unfused w8a8 "
                f"{state['fwd_ms_w8a8']:.2f} ms in this run); batch 1 "
                f"latency p50 {lat:.2f} ms ({state['smi']})")
            if state.get("profile_dir"):
                tag = "_w8a8_int8qk" if int8_qk else "_w8a8_fused"
                _profile(lambda: clf._forward(x), 3,
                         f"batch-16 forward, {variant}", fwd_ms, state["smi"],
                         os.path.join(state["profile_dir"],
                                      f"profile_slice{tag}.txt"), tag, 25)
    finally:
        ek.set_fused_extras(False)
        fa.set_int8_qk(False)
    # both switches off again: the unfused forward, bit for bit
    if not torch.equal(_w8a8_logits(clf, x, "kernel"), base):
        raise AssertionError("the switches did not reset")


# ---------------------------------------------------------------------------
# the training and evaluation programs
# ---------------------------------------------------------------------------

# launches per step under set_flash_bwd_mode("recompute"): the forward that
# writes no denominators and the backward that rebuilds them, 12 blocks each
RECOMPUTE_PER_STEP = {"packed_attention": 12,
                      "packed_attention_bwd_recompute": 12,
                      "packed_attention_den": 0, "packed_attention_bwd": 0,
                      "streaming_attention": 12,
                      "streaming_attention_bwd": 12}
RECOMPUTE_STEPS = 3


def _loss_and_grads(state):
    """One loss + backward of the train-slice model on its fixed batch (no
    update): (loss, gradient leaves, launch counts)."""
    import torch
    ts, loss_fn = state["train_state"], state["train_loss_fn"]
    ts.optimizer.zero_grad(set_to_none=True)
    _reset_launch_counts()
    total, _ = loss_fn(ts.trainable, ts.frozen, state["train_batch"])
    total.backward()
    torch.cuda.synchronize()
    grads = _grad_list(ts.trainable)
    ts.optimizer.zero_grad(set_to_none=True)
    return total.item(), grads, _launch_counts()


def phase_train_recompute(state):
    """The training step with the backward that saves no forward output."""
    import torch
    from gava_clip_tpu_torch.ops import flash_attention as fa
    ts, step, batch = (state[k] for k in ("train_state", "train_step",
                                          "train_batch"))
    loss_s, g_s, _ = _loss_and_grads(state)
    try:
        fa.set_flash_bwd_mode("recompute")
        loss_r, g_r, n_r = _loss_and_grads(state)
        fa.set_flash_bwd_mode("saved")
        loss_s2, g_s2, n_s2 = _loss_and_grads(state)
        fa.set_flash_bwd_mode("recompute")
        d_loss = abs(loss_r - loss_s)
        scale = max(g.norm().item() for g in g_s)
        rel = [((a - b).norm() / b.norm().clamp_min(1e-3 * scale)).item()
               for a, b in zip(g_r, g_s)]
        back = loss_s2 == loss_s and all(torch.equal(a, b)
                                         for a, b in zip(g_s2, g_s))
        log(f"[train-recompute] first step, recompute vs saved mode: total "
            f"{loss_r:.6f} vs {loss_s:.6f} (diff {d_loss:.2e}, limit "
            f"{TRAIN_MAX_LOSS_DIFF:g}); gradient leaves {len(rel)}, max "
            f"relative L2 error {max(rel):.3e}, median "
            f"{float(np.median(rel)):.3e} (limit {TRAIN_MAX_GRAD_REL_ERR:g}); "
            f"launches {n_r}; back in saved mode the loss and every gradient "
            f"equal the first pass bit for bit: {back}")
        if d_loss > TRAIN_MAX_LOSS_DIFF or max(rel) > TRAIN_MAX_GRAD_REL_ERR \
                or not back or \
                any(n_r[k] != v for k, v in RECOMPUTE_PER_STEP.items()) or \
                any(n_s2[k] != v for k, v in TRAIN_PER_STEP.items()):
            raise AssertionError("the recompute mode failed its checks")
        del g_s, g_r, g_s2
        _reset_launch_counts()
        totals, dev_ms = [], []
        for _ in range(RECOMPUTE_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            ts, metrics = step(ts, batch)
            ev[1].record()
            totals.append(metrics["total"].item())
            dev_ms.append(ev[0].elapsed_time(ev[1]))
        counts = _launch_counts()
    finally:
        fa.set_flash_bwd_mode("saved")
    state.setdefault("launches_by_kernel", {})[
        "packed_attention_bwd_recompute"] = \
        counts["packed_attention_bwd_recompute"]
    log(f"[train-recompute] {RECOMPUTE_STEPS} steps: total "
        f"{[round(t, 4) for t in totals]}; launches {counts} (expect "
        f"{RECOMPUTE_PER_STEP} per step); step by CUDA events "
        f"{[round(t, 1) for t in dev_ms]} ms (saved mode "
        f"{state['train_ms']:.2f} ms) ({state['smi']})")
    if not all(np.isfinite(totals)) or any(
            counts[k] != v * RECOMPUTE_STEPS
            for k, v in RECOMPUTE_PER_STEP.items()):
        raise AssertionError("the recompute-mode steps failed their checks")
    # one more saved-mode step: the default path is back
    _reset_launch_counts()
    ts, metrics = step(ts, batch)
    torch.cuda.synchronize()
    counts = _launch_counts()
    if any(counts[k] != v for k, v in TRAIN_PER_STEP.items()):
        raise AssertionError(f"after the reset: launches {counts}")


FOLD_CLASSES = ("normal\nslight difficulty\nmoderate difficulty\n"
                "*normal\n*slight\n*moderate\n")
KNOWLEDGE_VERSIONS = ("v1", "v2", "v3", "v4", "v5")
CLI_STEPS = 12
CLI_PRINT_FREQ = 2
CLI_SAVE_FREQ = 6
# data-root substrings that the fold remapping of the training program
# rewrites (utils/config.remap_fold_data_root)
_REMAPPED = ("park", "mix", "real", "miccai", "tulip", "sep")


def _separable_clip(rs, label: int, T: int, S: int = 224) -> np.ndarray:
    """A uint8 clip (T, S, S, 3) whose class shows in its brightness and in
    the direction of a gradient, under uniform noise."""
    ramp = np.linspace(0.0, 1.0, S, dtype=np.float32)
    base = (ramp[None, :], ramp[:, None],
            np.abs(ramp[:, None] - ramp[None, :]))[label]
    img = 40.0 + 70.0 * label + 60.0 * np.broadcast_to(base, (S, S))
    clip = img[None, :, :, None] + rs.uniform(-25, 25, (T, S, S, 3))
    return np.clip(clip, 0, 255).astype(np.uint8)


def _write_fold(root: str, T: int, n_train: int, n_val: int, seed: int = 0):
    """A synthetic fold under `root`: lists, decoded-view cache files in
    place of videos (no decoder needed), NTE arrays, the memory pickle, the
    knowledge directory and a classes file. Returns the program's data
    arguments."""
    import pickle
    from gava_clip_tpu_torch.data.datasets import (VideoDataset,
                                                   VideoDatasetConfig)
    from gava_clip_tpu_torch.utils.flagship import make_synthetic_knowledge_dir
    if any(w in root for w in _REMAPPED):
        raise RuntimeError(f"temporary directory {root} contains one of "
                           f"{_REMAPPED}, which the fold remapping rewrites")
    rs = np.random.RandomState(seed)
    cache = os.path.join(root, "cache")
    os.makedirs(os.path.join(root, "nte"))
    for split, n in (("train", n_train), ("val", n_val)):
        rows = [(f"{split}vid{i:03d}.mp4", i % 3) for i in range(n)]
        lst = os.path.join(root, f"{split}_updrs.csv")
        with open(lst, "w") as f:
            f.write("".join(f"{p},{c}\n" for p, c in rows))
        ds = VideoDataset(VideoDatasetConfig(
            list_path=lst, data_root=root, num_spatial_views=1,
            num_temporal_views=1, num_frames=T, sampling_rate=1,
            is_train=split == "train", cache_dir=cache))
        for path, label in rows:
            ds._cache_store(path, _separable_clip(rs, label, T)[None])
            np.save(os.path.join(root, "nte", path.split(".")[0] + ".npy"),
                    rs.randn(70, 512).astype(np.float32))
    with open(os.path.join(root, "mem.pkl"), "wb") as f:
        pickle.dump({"embeds": rs.randn(192, 4, 512).astype(np.float32),
                     "updrs": np.arange(192) % 3}, f)
    classes = os.path.join(root, "classes.txt")
    with open(classes, "w") as f:
        f.write(FOLD_CLASSES)
    kdir = make_synthetic_knowledge_dir(3, KNOWLEDGE_VERSIONS)
    args = ["--nfold", "1", "--type", "updrs", "--data_root", root,
            "--text_prompt_classes_path", classes,
            "--decoded_cache_dir", cache, "--num_temporal_views", "1",
            "--num_frames", str(T), "--use_bf16",
            "--use_text_prompt_learning", "--use_text_prompt_CSC",
            "--text_num_prompts", "8",
            "--text_prompt_init", "cntn_split_uni_disc",
            "--knowledge_dir", kdir,
            "--use_summary_token", "--use_local_prompts",
            "--use_global_prompts", "--use_support_memory",
            "--memory_data_path", os.path.join(root, "mem.pkl"),
            "--mem_batch_size", "64", "--clLoss_nte_video",
            "--use_focal_ordinal_loss", "--num_workers", "4"]
    for kv in KNOWLEDGE_VERSIONS:
        args += ["--knowledge_version", kv]
    return args, kdir


def _run_records(logdir: str):
    with open(os.path.join(logdir, "fold_0", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _only_logdir(before):
    new = sorted(set(os.listdir("logs")) - before)
    if len(new) != 1:
        raise AssertionError(f"expected one new run directory, got {new}")
    return os.path.join("logs", new[0])


def _train_main(argv, tag: str):
    """cli.train.main in a run directory of its own: (logdir, records)."""
    from gava_clip_tpu_torch.cli import train as cli_train
    os.makedirs("logs", exist_ok=True)
    before = set(os.listdir("logs"))
    t0 = time.perf_counter()
    cli_train.main(argv)
    secs = time.perf_counter() - t0
    logdir = _only_logdir(before)
    os.rename(logdir, os.path.join("logs", tag))   # the name holds a minute
    logdir = os.path.join("logs", tag)
    log(f"[driver] {tag}: cli.train.main returned in {secs:.1f} s")
    return logdir, _run_records(logdir)


def _reference_state_dict(params) -> dict:
    """The port's `visual` / `textual` trees under the reference model's
    state-dict names (the inverse of utils/torch_convert), to write a
    .pth that the zero-shot program loads."""
    import torch
    sd = {}

    def lin(name, p):
        sd[f"{name}.weight"] = p["kernel"].t().contiguous()
        if p.get("bias") is not None:
            sd[f"{name}.bias"] = p["bias"]

    def ln(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p["scale"], p["bias"]

    vis = params["visual"]
    D = vis["patch_embed"]["kernel"].shape[1]
    sd["visual.patch_embed.proj.weight"] = vis["patch_embed"]["kernel"] \
        .reshape(16, 16, 3, D).permute(3, 2, 0, 1).contiguous()
    sd["visual.patch_embed.proj.bias"] = vis["patch_embed"]["bias"]
    for name in ("cls_token", "pos_embed", "time_embed", "proj",
                 "global_prompts"):
        sd[f"visual.{name}"] = vis[name]
    ln("visual.ln_pre", vis["ln_pre"])
    ln("visual.ln_post", vis["ln_post"])
    for i, b in enumerate(vis["blocks"]):
        pre = f"visual.blocks.{i}"
        for n in ("q", "k", "v", "out"):
            lin(f"{pre}.attn.{n}_proj", b["attn"][n])
            lin(f"{pre}.summary_attn_layer.{n}_proj", b["summary_attn"][n])
        ln(f"{pre}.norm1", b["norm1"])
        ln(f"{pre}.norm2", b["norm2"])
        ln(f"{pre}.summary_ln", b["summary_ln"])
        lin(f"{pre}.mlp.fc1", b["mlp"]["fc1"])
        lin(f"{pre}.mlp.fc2", b["mlp"]["fc2"])
        lin(f"{pre}.cls_proj", b["cls_proj"])
        sd[f"{pre}.local_prompts"] = b["local_prompts"]
    txt = params["textual"]
    sd["textual.token_embedding.weight"] = txt["token_embedding"]
    sd["textual.positional_embedding"] = txt["positional_embedding"]
    sd["textual.text_projection"] = txt["text_projection"]
    ln("textual.ln_final", txt["ln_final"])
    for i, b in enumerate(txt["blocks"]):
        pre = f"textual.transformer.resblocks.{i}"
        a = b["attn"]
        sd[f"{pre}.attn.in_proj_weight"] = torch.cat(
            [a[n]["kernel"].t() for n in ("q", "k", "v")]).contiguous()
        sd[f"{pre}.attn.in_proj_bias"] = torch.cat(
            [a[n]["bias"] for n in ("q", "k", "v")])
        lin(f"{pre}.attn.out_proj", a["out"])
        ln(f"{pre}.ln_1", b["ln_1"])
        ln(f"{pre}.ln_2", b["ln_2"])
        lin(f"{pre}.mlp.c_fc", b["mlp"]["fc1"])
        lin(f"{pre}.mlp.c_proj", b["mlp"]["fc2"])
    return {k: v.detach().float().cpu() for k, v in sd.items()}


def phase_cli(state):
    """cli.train, cli.evaluate and cli.zero_shot at full width on a
    synthetic fold."""
    import shutil
    import tempfile
    import torch
    from gava_clip_tpu_torch.cli import evaluate as cli_eval
    from gava_clip_tpu_torch.cli import train as cli_train
    from gava_clip_tpu_torch.cli import zero_shot as cli_zs
    from gava_clip_tpu_torch.train import checkpoint as ckpt_lib
    for key in ("train_step", "train_state", "train_batch", "train_loss_fn"):
        state.pop(key, None)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="gava_fold_")
    cwd = os.getcwd()
    kdir = None
    try:
        t0 = time.perf_counter()
        data_args, kdir = _write_fold(root, T=8, n_train=64, n_val=32)
        log(f"[driver] synthetic fold written in "
            f"{time.perf_counter() - t0:.1f} s: 64 train + 32 val clips of "
            f"8 x 224 x 224 x 3 uint8 as decoded-view cache files, NTE "
            f"arrays, memory pickle, knowledge directory")
        os.chdir(root)
        train_args = data_args + [
            "--batch_size", "16", "--num_steps", str(CLI_STEPS),
            "--print_freq", str(CLI_PRINT_FREQ), "--lr", "1e-3",
            "--eval_freq", str(CLI_STEPS)]
        _reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        run_a, rec_a = _train_main(
            train_args + ["--save_freq", str(CLI_SAVE_FREQ)], "run_a")
        counts = _launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        save_secs = dict(ckpt_lib.last_save_seconds)
        eval_rate = cli_train.last_eval["clips"] / \
            cli_train.last_eval["seconds"]
        steps_a = [r for r in rec_a if "loss" in r]
        loss_a = {r["step"]: r["loss"] for r in steps_a}
        # sustained time per step between print steps, the first window
        # (set-up, warm-up) left out
        sustained = [(b["t"] - a["t"]) / (b["step"] - a["step"]) * 1e3
                     for a, b in zip(steps_a[1:], steps_a[2:])]
        data_ms = [r["data_time_s"] * 1e3 for r in steps_a[1:]]
        log(f"[driver] run_a: {CLI_STEPS} steps of 16 clips x 8 frames, "
            f"bf16, flash, prefetch 2: loss at the print steps "
            f"{ {k: round(v, 4) for k, v in loss_a.items()} }; sustained "
            f"{[round(x, 1) for x in sustained]} ms/step between print steps "
            f"(median {np.median(sustained):.2f}; the bare step "
            f"{state['train_ms']:.2f} ms by CUDA events), data_time "
            f"{[round(x, 1) for x in data_ms]} ms; evaluation "
            f"{eval_rate:.1f} clips/s over "
            f"{cli_train.last_eval['clips']} clips; last checkpoint: fetch "
            f"{save_secs['fetch']:.2f} s, write {save_secs['write']:.2f} s; "
            f"peak memory {peak:.2f} GiB; launches {counts} "
            f"({state['smi']})")
        first, last = steps_a[:2], steps_a[-2:]
        if not all(np.isfinite(list(loss_a.values()))) or not \
                np.mean([r["loss"] for r in last]) < \
                np.mean([r["loss"] for r in first]):
            raise AssertionError(f"the program's loss did not fall: {loss_a}")
        # 12 steps + 2 evaluation batches of 12 blocks
        want = {"packed_attention_den": 12 * CLI_STEPS,
                "packed_attention_bwd": 12 * CLI_STEPS,
                "packed_attention": 24,
                "streaming_attention_bwd": 12 * CLI_STEPS}
        if any(counts[k] != v for k, v in want.items()):
            raise AssertionError(f"launches {counts}, expected {want}")
        state["launches_cli"] = counts
        files = set(os.listdir(run_a))
        fold_files = set(os.listdir(os.path.join(run_a, "fold_0")))
        need = {"config.yaml", "results.txt", "confusion_matrix_fold-0.txt",
                "confusion_matrix_total.txt"}
        need_fold = {"metrics.jsonl", "fold-0-best.ckpt",
                     f"checkpoint-{CLI_SAVE_FREQ}.ckpt",
                     f"checkpoint-{CLI_STEPS}.ckpt"}
        if not need <= files or not need_fold <= fold_files:
            raise AssertionError(f"files of the run: {sorted(files)}, "
                                 f"{sorted(fold_files)}")
        with open(os.path.join(run_a, "results.txt")) as f:
            txt = f.read()
        best = ckpt_lib.load_checkpoint(
            os.path.join(run_a, "fold_0", "fold-0-best.ckpt"))
        if "Average F1-score" not in txt or \
                best["next_step"] != CLI_STEPS or \
                best["text_features"].shape != (3, 512) or \
                not any("eval_macro_f1" in r for r in rec_a):
            raise AssertionError("the run's reports are incomplete")
        conf_a = np.loadtxt(os.path.join(run_a,
                                         "confusion_matrix_fold-0.txt"))
        del best

        # the same run without the device prefetch and with the clamp
        # monitor: the same losses
        import contextlib
        import io
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run_b, rec_b = _train_main(
                train_args + ["--save_freq", "1000", "--device_prefetch", "0",
                              "--debug_attn_clamp"], "run_b")
        out_b = buf.getvalue()
        sys.stdout.write(out_b)
        from gava_clip_tpu_torch.ops import flash_attention as fa
        clamp = dict(fa.read_clamp_stats())
        fa.enable_clamp_monitor(False)
        steps_b = [r for r in rec_b if "loss" in r]
        loss_b = {r["step"]: r["loss"] for r in steps_b}
        sustained_b = [(b["t"] - a["t"]) / (b["step"] - a["step"]) * 1e3
                       for a, b in zip(steps_b[1:], steps_b[2:])]
        log(f"[driver] run_b (--device_prefetch 0, --debug_attn_clamp): "
            f"losses equal run_a's: {loss_b == loss_a}; sustained "
            f"{np.median(sustained_b):.2f} ms/step, data_time "
            f"{[round(r['data_time_s'] * 1e3, 1) for r in steps_b[1:]]} ms; "
            f"clamp monitor: max exp2 argument {clamp['max_exp2_arg']:.2f} "
            f"over {clamp['calls']} calls, clipped {clamp['clipped']}")
        if loss_b != loss_a or "attn_max_exp2_arg" not in out_b or \
                not 0.0 < clamp["max_exp2_arg"] < 110.0 or clamp["clipped"] \
                or clamp["calls"] < 12 * CLI_STEPS:
            raise AssertionError("prefetch off / clamp monitor run failed")
        shutil.rmtree(run_b)

        # resume from the periodic checkpoint: the uninterrupted run's losses
        os.makedirs("resume_from")
        shutil.copy(os.path.join(run_a, "fold_0",
                                 f"checkpoint-{CLI_SAVE_FREQ}.ckpt"),
                    "resume_from")
        run_c, rec_c = _train_main(
            train_args + ["--save_freq", "1000", "--auto_resume",
                          "--checkpoint_dir", "resume_from"], "run_c")
        loss_c = {r["step"]: r["loss"] for r in rec_c if "loss" in r}
        tail = {k: v for k, v in loss_a.items() if k >= CLI_SAVE_FREQ}
        conf_c = np.loadtxt(os.path.join(run_c,
                                         "confusion_matrix_fold-0.txt"))
        log(f"[driver] run_c (--auto_resume from checkpoint-"
            f"{CLI_SAVE_FREQ}): steps {sorted(loss_c)}, losses equal the "
            f"uninterrupted run's: {loss_c == tail}, confusion matrix equal: "
            f"{np.array_equal(conf_c, conf_a)}")
        if loss_c != tail or not np.array_equal(conf_c, conf_a):
            raise AssertionError(f"resumed run {loss_c} vs {tail}")
        shutil.rmtree(run_c)
        shutil.rmtree("resume_from")

        # cli.evaluate on run_a: plain, then w8a8
        eval_args = ["--checkpoint_dir", run_a, "--data_root", root,
                     "--val_list_path", os.path.join(root, "val_updrs.csv"),
                     "--text_prompt_classes_path",
                     os.path.join(root, "classes.txt")]
        perf, conf = cli_eval.main(eval_args)
        plain_rate = cli_train.last_eval["clips"] / \
            cli_train.last_eval["seconds"]
        _reset_launch_counts()
        perf8, conf8 = cli_eval.main(eval_args + ["--quantize_eval", "w8a8"])
        n8 = _launch_counts()
        w8a8_rate = cli_train.last_eval["clips"] / \
            cli_train.last_eval["seconds"]
        log(f"[driver] cli.evaluate on run_a: accuracy {perf[0]:.4f}, "
            f"confusion {conf.tolist()} (the training run's best "
            f"{conf_a.astype(int).tolist()}), {plain_rate:.1f} clips/s; "
            f"--quantize_eval w8a8: accuracy {perf8[0]:.4f}, confusion "
            f"{conf8.tolist()}, {w8a8_rate:.1f} clips/s, launches "
            f"attention_out_int8 {n8['attention_out_int8']}, w8a8_mlp_res "
            f"{n8['w8a8_mlp_res']}")
        if not np.array_equal(conf, conf_a) or conf8.sum() != 32 or \
                n8["attention_out_int8"] != 24 or \
                not any(f.startswith("eval_") for f in os.listdir(run_a)):
            raise AssertionError("cli.evaluate failed its checks")

        # cli.zero_shot on reference-format files written from a model's
        # own weights
        from gava_clip_tpu_torch.utils.flagship import build_flagship
        model = build_flagship(num_frames=8, knowledge_dir=kdir)
        sd = _reference_state_dict(model.params)
        torch.save(sd, "clip_backbone.pth")
        vlm = {f"module.{k}": v for k, v in sd.items()
               if k.startswith("visual.")}
        vlm["module.logit_scale"] = model.params["logit_scale"].cpu()
        torch.save({"model": vlm}, "vlm.pth")
        want_tf = model.params["textual"]["text_projection"].shape
        del model, sd, vlm
        zs_perf, zs_conf = cli_zs.main([
            "--type", "updrs", "--eval_data_root", root,
            "--eval_list_path", os.path.join(root, "val_updrs.csv"),
            "--text_prompt_classes_path", os.path.join(root, "classes.txt"),
            "--backbone_path", "clip_backbone.pth",
            "--pretrained_vlm", "vlm.pth", "--info_dir", "zs_info",
            "--decoded_cache_dir", os.path.join(root, "cache"),
            "--batch_size", "16", "--num_frames", "8",
            "--num_temporal_views", "1", "--use_bf16", "--num_workers", "4"])
        tf = np.load(os.path.join("zs_info", "ke_updrs",
                                  "text_features_v0.npy"))
        log(f"[driver] cli.zero_shot: accuracy {zs_perf:.4f}, confusion "
            f"{zs_conf.tolist()}, text features {tf.shape}")
        if zs_conf.sum() != 32 or tf.shape != (3, want_tf[1]) or \
                not np.isfinite(tf).all() or \
                not os.path.isfile("eval_output/class_name.txt"):
            raise AssertionError("cli.zero_shot failed its checks")
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
        if kdir:
            shutil.rmtree(kdir, ignore_errors=True)


REMAT_POLICIES = ("none", "full", "save_attn", "save_attn_qkv",
                  "save_attn_mlp", "dots")
# attention forward launches per step at 12 blocks: the policies that keep
# the attention output launch it once per block
REMAT_FORWARDS = {"none": 12, "full": 24, "save_attn": 12,
                  "save_attn_qkv": 12, "save_attn_mlp": 12, "dots": 24}


def phase_cli_long(state):
    """The long clip: cli.train.main at 4 x 70 (the program picks
    save_attn_qkv), then the bare step under every remat policy."""
    import shutil
    import tempfile
    import torch
    from gava_clip_tpu_torch.cli import train as cli_train
    from gava_clip_tpu_torch.models.vita_clip import trainable_mask
    from gava_clip_tpu_torch.train.state import (create_train_state,
                                                 make_optimizer)
    from gava_clip_tpu_torch.train.step import LossConfig, make_train_step
    from gava_clip_tpu_torch.utils.flagship import build_flagship
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="gava_long_")
    cwd = os.getcwd()
    kdir = None
    seen = {}
    make = cli_train.make_train_step

    def spy(*a, **kw):
        seen["remat"] = kw.get("remat")
        return make(*a, **kw)

    try:
        data_args, kdir = _write_fold(root, T=70, n_train=8, n_val=4)
        os.chdir(root)
        cli_train.make_train_step = spy
        _reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        run, rec = _train_main(data_args + [
            "--batch_size", "4", "--num_steps", "3", "--print_freq", "1",
            "--lr", "5e-6", "--eval_freq", "1000", "--save_freq", "1000"],
            "run_long")
        counts = _launch_counts()
        losses = [r["loss"] for r in rec if "loss" in r]
        log(f"[driver-long] cli.train.main at 4 clips x 70 frames, 3 steps: "
            f"remat {seen.get('remat')!r}, losses "
            f"{[round(x, 4) for x in losses]}, batch_time "
            f"{[r['batch_time_s'] for r in rec if 'loss' in r]} s, peak "
            f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
            f"launches {counts}")
        if seen.get("remat") != "save_attn_qkv" or len(losses) != 3 or \
                not all(np.isfinite(losses)) or \
                counts["packed_attention_den"] != 36 or \
                counts["packed_attention_bwd"] != 36:
            raise AssertionError("the long-clip run failed its checks")
    finally:
        cli_train.make_train_step = make
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
        if kdir:
            shutil.rmtree(kdir, ignore_errors=True)

    loss_cfg = LossConfig(num_classes=3, focal_ordinal=True, fo_beta=0.2,
                          use_support_memory=True, add_nte=True)
    opt = make_optimizer(lr=5e-6, num_steps=2000, weight_decay=0.2)
    model = build_flagship(num_frames=70)
    ts = create_train_state(model.params,
                            trainable_mask(model.params, model.cfg), opt)
    batch = _train_batch(4, 70)
    table = {}
    for policy in REMAT_POLICIES:
        step = make_train_step(model, loss_cfg, opt, remat=policy,
                               compute_dtype=torch.bfloat16,
                               attn_impl="flash")
        torch.cuda.empty_cache()
        ts, metrics = step(ts, batch)                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        dev_ms = []
        for _ in range(2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            ts, metrics = step(ts, batch)
            ev[1].record()
            total = metrics["total"].item()
            dev_ms.append(ev[0].elapsed_time(ev[1]))
        counts = _launch_counts()
        fwd = (counts["packed_attention_den"] + counts["packed_attention"]) \
            // 2
        table[policy] = (float(np.mean(dev_ms)),
                         torch.cuda.max_memory_allocated() / 2 ** 30, fwd)
        log(f"[driver-long] remat {policy}: {table[policy][0]:.2f} ms/step "
            f"(CUDA events, {[round(t, 1) for t in dev_ms]}), peak memory "
            f"{table[policy][1]:.2f} GiB, attention forward launches per "
            f"step {fwd} (expect {REMAT_FORWARDS[policy]}), backward "
            f"{counts['packed_attention_bwd'] // 2}; total {total:.4f} "
            f"({state['smi']})")
        if not np.isfinite(total) or fwd != REMAT_FORWARDS[policy] or \
                counts["packed_attention_bwd"] != 24:
            raise AssertionError(f"remat {policy} failed its checks")
    state["remat_table"] = table


def _profile(fn, runs: int, what: str, ms: float, smi: str, path: str,
             tag: str, rows: int):
    """torch.profiler over `runs` calls of fn: self device time by
    operator (the hand-written kernels by their symbols) and the device's
    busy share of the measured time `ms`; written to `path`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    ops, busy = [], 0.0
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == DeviceType.CUDA:
            busy += dev                         # a kernel, memcpy or memset
            if any(name in e.key for name in KERNEL_SYMBOLS):
                ops.append((dev, e.count, e.key))   # launched via ctypes
        elif dev > 0 and not e.key.startswith(("_PackedAttention",
                                               "_StreamingAttention")):
            # the op that launched them (the attention Functions' own
            # kernels are listed by symbol above)
            ops.append((dev, e.count, e.key))
    ops.sort(reverse=True)
    busy_ms = busy / runs / 1e3
    lines = [f"{what}: {ms:.3f} ms by CUDA events, device kernels "
             f"{busy_ms:.3f} ms of it (traced), idle share "
             f"{100 * (1 - busy_ms / ms):.1f}%, {smi}",
             "self device ms per run | calls per run | op"]
    lines += [f"{dev / runs / 1e3:9.3f} | {n / runs:6.1f} | {key}"
              for dev, n, key in ops[:rows]]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    for line in lines[:16]:
        log(f"[profile{tag}] {line}")


def profile_train(state, out_dir: str):
    """2 training steps at batch 16."""
    step, batch = state["train_step"], state["train_batch"]
    _profile(lambda: step(state["train_state"], batch), 2,
             "batch-16 training step", state["train_ms"], state["smi"],
             os.path.join(out_dir, "profile_train.txt"), "_train", 32)


def profile_slice(state, out_dir: str, tag: str = ""):
    """3 device forwards of a serving classifier at batch 16."""
    clf = state[f"clf{tag}"]
    x = clf._prepare(state["clips"])
    _profile(lambda: clf._forward(x), 3, "batch-16 forward",
             state[f"fwd_ms{tag}"], state["smi"],
             os.path.join(out_dir, f"profile_slice{tag}.txt"), tag, 25)


def phase_server(state, tag: str = ""):
    from gava_clip_tpu_torch.server import serve
    clf, clips = state[f"clf{tag}"], state["clips"]
    httpd = serve(clf, "127.0.0.1", 0)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert r.status == 200

        def post(i):
            req = urllib.request.Request(
                base + "/v1/classify_clip_raw", data=clips[i].tobytes(),
                method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())

        with ThreadPoolExecutor(4) as ex:
            res = list(ex.map(post, range(4)))
        for status, body in res:
            if status != 200 or len(body["probs"]) != len(clf.classnames) or \
                    abs(sum(body["probs"]) - 1.0) > 1e-3:
                raise AssertionError(f"bad response {status}")
        log(f"[server{tag}] 4 concurrent /v1/classify_clip_raw: all 200, labels "
            f"{[b['label'] for _, b in res]}, batcher {httpd.batcher.stats}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.stop()
        th.join(timeout=10)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default="",
                    help="after each slice phase, write a torch.profiler "
                         "breakdown of the batch-16 forward (and of the "
                         "training step) to this directory")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import_port()
    # plain references in full fp32 / full-precision bf16 reductions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    state = {"profile_dir": args.profile}
    slice_tags = {"slice": "", "w8a8-slice": "_w8a8", "w8-slice": "_w8"}
    for name, phase in (
            ("device", phase_device), ("build", phase_build),
            ("kernel", phase_kernel), ("w8a8-kernel", phase_w8a8_kernels),
            ("train-kernel", phase_train_kernels),
            ("w8-kernel", phase_w8_kernels),
            ("slice", phase_slice), ("w8a8-slice", phase_w8a8_slice),
            ("w8-slice", phase_w8_slice),
            ("w8a8-variants", phase_w8a8_variants),
            ("server", phase_server),
            ("w8a8-server", lambda st: phase_server(st, "_w8a8")),
            ("w8-server", lambda st: phase_server(st, "_w8")),
            ("train-slice", phase_train_slice),
            ("train-recompute", phase_train_recompute),
            ("driver", phase_cli),
            ("train-long", phase_train_long),
            ("driver-long", phase_cli_long)):
        t0 = time.perf_counter()
        phase(state)
        log(f"[{name}] done in {time.perf_counter() - t0:.1f} s "
            f"({_card_state()})")
        if name in slice_tags and args.profile:
            profile_slice(state, args.profile, slice_tags[name])
        if name == "train-slice" and args.profile:
            profile_train(state, args.profile)
        if name == "w8-server":
            # the serving phases are done: free their weights before the
            # training step
            for key in ("clf", "clf_w8a8", "clf_w8", "model", "params",
                        "clips"):
                state.pop(key, None)
            torch.cuda.empty_cache()
    _assert_no_jax()
    kernels = [{"name": "packed_attention", "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
                "launches": state["launches"],
                "max_abs_err": state["max_abs_err"],
                "ms": state["ms"], "plain_ms": state["plain_ms"],
                "bound_ms": state["b1_bound"][0],
                "bound_by": state["b1_bound"][1],
                "library_ms": state["b1_library_ms"]}]
    for name, stats in state["kstats"].items():
        _, source, replaces = KERNELS[name]
        # the count from the run of the kernel's own main path
        launches = state["launches_by_kernel"] \
            if name in state["launches_by_kernel"] \
            else state["launches_w8a8"] if name in W8A8_PER_FORWARD \
            else state["launches_train"]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **stats})
    missing = sorted(set(KERNELS) - {e["name"] for e in kernels})
    if missing:
        raise AssertionError(f"kernels without a check and a time: {missing}")
    for entry in kernels:
        if entry["launches"] < 1:
            raise AssertionError(f"{entry['name']} was never launched on "
                                 f"its main path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(state["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
