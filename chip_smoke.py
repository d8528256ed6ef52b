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
  server  that classifier behind gava_clip_tpu.server.serve on localhost,
          4 concurrent /v1/classify_clip_raw requests.
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

Any failure raises and the script exits nonzero without printing a result.
On success the line before the last is a JSON object describing each kernel
and the last line is {"ok": true, "device": {...}}. Imports no JAX.
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
                  "w8a8_mlp_res_kernel")
KERNEL_SOURCE = "gava_clip_tpu_torch/csrc/packed_attention.cu"
KERNEL_REPLACES = "gava_clip_tpu/ops/flash_attention.py:181"
# every kernel of the two serving paths: launch-count name -> (library,
# source, the TPU kernel it replaces)
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
    assert "jax" not in sys.modules


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
W8A8_LIMITS = {
    "w8a8_matmul": (0.0, 0.0, 0.0),
    "w8a8_matmul3_cat": (1e-3, 1e-4, 2.0),
    "attention_out_int8": (1e-2, 2e-3, 4.0),
    "w8a8_mlp_res": (5e-3, 1e-3, 2.0),
}
# shapes: the serving shape first, then ragged ones (M not a multiple of
# the tile, odd N, K not a multiple of 64, Le = 0, lq < Lkv)
W8A8_MATMUL_SHAPES = ((25088, 768, 768), (37, 768, 77), (45, 100, 33))
W8A8_QKV_SHAPES = ((128, 197, 17, 768, 768), (3, 13, 5, 96, 40),
                   (4, 21, 0, 768, 768), (2, 9, 0, 64, 19))
# (B, lq, Lq rows of q, Lk, H)
W8A8_ATTN_SHAPES = ((128, 197, 214, 214, 12), (3, 13, 21, 21, 2),
                    (2, 77, 77, 150, 4), (2, 40, 100, 100, 12))
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

    def run(name, label, kernel, plain, unit, first):
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
            state.setdefault("kstats", {})[name] = {
                "max_abs_err": err, "ms": sum(t["kernel"]) / 2,
                "plain_ms": sum(t["plain"]) / 2}
            log(f"[w8a8] {name} serving shape: kernel {t['kernel']} ms, "
                f"plain {t['plain']} ms (order plain, kernel, kernel, "
                f"plain; {state['smi']})")

    for i, (M, K, N) in enumerate(W8A8_MATMUL_SHAPES):
        x = torch.randint(0, 256, (M, K), generator=gen,
                          device="cuda").to(bf)
        kern = _qleaf(gen, K, N)
        b = torch.randn(N, generator=gen, device="cuda") * 0.1
        unit = _flip_unit(im.quant_rows(x.float())[1], kern["scale"])
        run("w8a8_matmul", f"M={M} K={K} N={N}",
            lambda: im.w8a8_matmul_cuda(x, kern, b),
            lambda: im.w8a8_matmul_plain(x, kern, b), unit, i == 0)

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
            unit, i == 0)

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
            unit, i == 0)

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
            lambda: im.w8a8_mlp_res_plain(x, fc1, fc2, ln, r), unit, i == 0)
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


def phase_slice(state):
    import torch
    from gava_clip_tpu.data.video import parse_classes_file
    from gava_clip_tpu_torch.data.device_preprocess import normalize_frames
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
    for name, p, n in (("16 clips", p16, 16), ("5 clips", p5, 5)):
        if p.shape != (n, 400) or not np.isfinite(p).all():
            raise AssertionError(f"{name}: bad probabilities {p.shape}")
        err = np.abs(p.sum(-1) - 1.0).max()
        if err > 1e-3:
            raise AssertionError(f"{name}: probabilities sum off by {err}")
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
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        clf.classify_clips(clips)
    e2e = time.perf_counter() - t0
    fwd_ms = cuda_time_ms(lambda: clf._forward(x), iters=iters)
    lat = []
    for _ in range(20):
        t1 = time.perf_counter()
        clf.classify_clips(clips[:1])
        lat.append((time.perf_counter() - t1) * 1e3)
    state.update(clf=clf, clips=clips, fwd_ms=fwd_ms, model=model,
                 params=params, labels=labels, p16_bf16=p16,
                 d_logit_bf16_paths=d_logit)
    log(f"[slice] batch 16: {16 * iters / e2e:.1f} clips/s end to end, "
        f"device forward {fwd_ms:.2f} ms = {16e3 / fwd_ms:.1f} clips/s; "
        f"batch 1 latency p50 {np.median(lat):.2f} ms ({state['smi']})")


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
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.ops import int8_matmul as im
    return {**fa.launch_counts, **im.launch_counts}


def _reset_launch_counts():
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.ops import int8_matmul as im
    fa.reset_launch_counts()
    im.reset_launch_counts()


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
    for name, p, n in (("16 clips", p16, 16), ("5 clips", p5, 5)):
        if p.shape != (n, 400) or not np.isfinite(p).all():
            raise AssertionError(f"{name}: bad probabilities {p.shape}")
        err = np.abs(p.sum(-1) - 1.0).max()
        if err > 1e-3:
            raise AssertionError(f"{name}: probabilities sum off by {err}")
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

    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        clf.classify_clips(clips)
    e2e = time.perf_counter() - t0
    fwd_ms = cuda_time_ms(lambda: clf._forward(x), iters=iters)
    plain_ms = cuda_time_ms(lambda: _w8a8_logits(clf, x, "plain"), iters=3,
                            warmup=1)
    lat = []
    for _ in range(20):
        t1 = time.perf_counter()
        clf.classify_clips(clips[:1])
        lat.append((time.perf_counter() - t1) * 1e3)
    state.update(clf_w8a8=clf, fwd_ms_w8a8=fwd_ms)
    log(f"[w8a8-slice] batch 16: {16 * iters / e2e:.1f} clips/s end to end, "
        f"device forward {fwd_ms:.2f} ms = {16e3 / fwd_ms:.1f} clips/s "
        f"(bf16 path {state['fwd_ms']:.2f} ms; the forward through the "
        f"plain versions {plain_ms:.2f} ms); batch 1 latency p50 "
        f"{np.median(lat):.2f} ms ({state['smi']})")


def profile_slice(state, out_dir: str, tag: str = ""):
    """torch.profiler over 3 device forwards at batch 16: self device time
    by operator, and the device's busy share of the forward's time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    clf = state[f"clf{tag}"]
    x = clf._prepare(state["clips"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            clf._forward(x)
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
        elif dev > 0:
            ops.append((dev, e.count, e.key))   # the op that launched them
    ops.sort(reverse=True)
    fwd_ms = state[f"fwd_ms{tag}"]
    busy_ms = busy / 3e3
    lines = [f"batch-16 forward: {fwd_ms:.3f} ms by CUDA events, device "
             f"kernels {busy_ms:.3f} ms of it per forward (traced), idle "
             f"share {100 * (1 - busy_ms / fwd_ms):.1f}%, {state['smi']}",
             "self device ms per forward | calls per forward | op"]
    lines += [f"{dev / 3e3:9.3f} | {n / 3:6.1f} | {key}"
              for dev, n, key in ops[:25]]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_slice{tag}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    for line in lines[:14]:
        log(f"[profile{tag}] {line}")


def phase_server(state, tag: str = ""):
    from gava_clip_tpu.server import serve
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
                    help="after the slice phase, write a torch.profiler "
                         "breakdown of the batch-16 forward to this "
                         "directory")
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
    state = {}
    for name, phase in (
            ("device", phase_device), ("build", phase_build),
            ("kernel", phase_kernel), ("w8a8-kernel", phase_w8a8_kernels),
            ("slice", phase_slice), ("w8a8-slice", phase_w8a8_slice),
            ("server", phase_server),
            ("w8a8-server", lambda st: phase_server(st, "_w8a8"))):
        t0 = time.perf_counter()
        phase(state)
        log(f"[{name}] done in {time.perf_counter() - t0:.1f} s")
        if name in ("slice", "w8a8-slice") and args.profile:
            profile_slice(state, args.profile,
                          "_w8a8" if name == "w8a8-slice" else "")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    kernels = [{"name": "packed_attention", "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
                "launches": state["launches"],
                "max_abs_err": state["max_abs_err"],
                "ms": state["ms"], "plain_ms": state["plain_ms"]}]
    for name, stats in state["kstats"].items():
        _, source, replaces = KERNELS[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": state["launches_w8a8"][name], **stats})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(state["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
