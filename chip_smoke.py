#!/usr/bin/env python3
"""Bring-up check of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --profile chiprun_out/profile   # + per-op table

Phases, each reported on its own lines:
  device  card name and power limit (nvidia-smi), torch / CUDA versions;
  build   compiles csrc/packed_attention.cu with nvcc for sm_90a, timed;
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
KERNEL_SOURCE = "gava_clip_tpu_torch/csrc/packed_attention.cu"
KERNEL_REPLACES = "gava_clip_tpu/ops/flash_attention.py:181"
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


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def phase_build(state):
    from gava_clip_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    _cuda.load_library("packed_attention")
    info = _cuda.build_info["packed_attention"]
    log(f"[build] packed_attention: nvcc {info['seconds']:.2f} s, load "
        f"{time.perf_counter() - t0:.2f} s total -> {info['so']}")
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
    state.update(clf=clf, clips=clips, fwd_ms=fwd_ms)
    log(f"[slice] batch 16: {16 * iters / e2e:.1f} clips/s end to end, "
        f"device forward {fwd_ms:.2f} ms = {16e3 / fwd_ms:.1f} clips/s; "
        f"batch 1 latency p50 {np.median(lat):.2f} ms ({state['smi']})")


def profile_slice(state, out_dir: str):
    """torch.profiler over 3 device forwards at batch 16: self device time
    by operator, and the device's busy share of the forward's time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from gava_clip_tpu_torch.ops import flash_attention as fa
    clf = state["clf"]
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
            if any(name in e.key for name in fa.launch_counts):
                ops.append((dev, e.count, e.key))   # launched via ctypes
        elif dev > 0:
            ops.append((dev, e.count, e.key))   # the op that launched them
    ops.sort(reverse=True)
    fwd_ms = state["fwd_ms"]
    busy_ms = busy / 3e3
    lines = [f"batch-16 forward: {fwd_ms:.3f} ms by CUDA events, device "
             f"kernels {busy_ms:.3f} ms of it per forward (traced), idle "
             f"share {100 * (1 - busy_ms / fwd_ms):.1f}%, {state['smi']}",
             "self device ms per forward | calls per forward | op"]
    lines += [f"{dev / 3e3:9.3f} | {n / 3:6.1f} | {key}"
              for dev, n, key in ops[:25]]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_slice.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    for line in lines[:14]:
        log(f"[profile] {line}")


def phase_server(state):
    from gava_clip_tpu.server import serve
    clf, clips = state["clf"], state["clips"]
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
        log(f"[server] 4 concurrent /v1/classify_clip_raw: all 200, labels "
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
    for name, phase in (("device", phase_device), ("build", phase_build),
                        ("kernel", phase_kernel), ("slice", phase_slice),
                        ("server", phase_server)):
        t0 = time.perf_counter()
        phase(state)
        log(f"[{name}] done in {time.perf_counter() - t0:.1f} s")
        if name == "slice" and args.profile:
            profile_slice(state, args.profile)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    kernel = {"name": "packed_attention", "route": "cuda",
              "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
              "launches": state["launches"],
              "max_abs_err": state["max_abs_err"],
              "ms": state["ms"], "plain_ms": state["plain_ms"]}
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(state["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
