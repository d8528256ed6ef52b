"""Build and bind the hand-written CUDA kernels in `gava_clip_tpu_torch/csrc/`.

Each `csrc/<name>.cu` exports plain C entry points. At first use it is
compiled with nvcc for sm_90a into `gava_clip_tpu_torch/_build/`, under a
file name that carries a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags (a stale build is never loaded), and bound
with ctypes. Pointers and the stream go over as c_void_p, sizes as c_int.
A missing nvcc or a failed build raises. `load_libraries` builds several
sources at once, one nvcc process each. No --use_fast_math: the w8a8
kernels rely on IEEE division and unfused fp32 roundings.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP, _I = ctypes.c_void_p, ctypes.c_int
# ctypes signature of every exported function, by source name
_SIGNATURES = {
    "packed_attention": {
        # q, k, v, o; B, Lq, Lk, H, Dh; q/k/v/o batch and row strides;
        # exp2 constant; stream
        "packed_attention_bf16": (
            [_VP] * 4 + [_I] * 5 + [_I] * 8 + [ctypes.c_float, _VP], _I),
        # the same with den after o
        "packed_attention_den_bf16": (
            [_VP] * 5 + [_I] * 5 + [_I] * 8 + [ctypes.c_float, _VP], _I),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "packed_attention_bwd": {
        # q, k, v, do, o, den, dq, dk, dv, scratch; B, Lq, Lk, H, Dh; q/k/v
        # batch and row strides; the launch plan (lq_pad, grid, accumulator
        # in shared memory?, shared bytes); scale; stream
        "packed_attention_bwd_bf16": (
            [_VP] * 10 + [_I] * 5 + [_I] * 6 + [_I] * 4
            + [ctypes.c_float, _VP], _I),
        # the shared-memory layout of the launch plan: three ints
        "packed_attention_bwd_layout": ([ctypes.POINTER(_I)], None),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "packed_attention_bwd_recompute": {
        # q, k, v, do, dq, dk, dv, scratch; then as packed_attention_bwd
        "packed_attention_bwd_recompute_bf16": (
            [_VP] * 8 + [_I] * 5 + [_I] * 6 + [_I] * 4
            + [ctypes.c_float, _VP], _I),
        # the shared-memory layout of the launch plan: three ints
        "packed_attention_bwd_layout": ([ctypes.POINTER(_I)], None),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "streaming_attention": {
        # q, k, v, o, lse; B, Lq, Lk, H, Dh; q/k/v batch and row strides;
        # scale; causal; stream
        "streaming_attention_fwd_bf16": (
            [_VP] * 5 + [_I] * 5 + [_I] * 6 + [ctypes.c_float, _I, _VP], _I),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "streaming_attention_bwd": {
        # q, k, v, do, o, lse, dq, dk, dv, scratch; B, Lq, Lk, H, Dh; q/k/v
        # batch and row strides; scale; causal; the launch plan (form,
        # groups, key tiles a group, lq_pad, accumulator in shared memory?,
        # shared bytes); stream
        "streaming_attention_bwd_bf16": (
            [_VP] * 10 + [_I] * 5 + [_I] * 6 + [ctypes.c_float] + [_I] * 7
            + [_VP], _I),
        # the two forms' layout: nine ints
        "streaming_attention_bwd_layout": ([ctypes.POINTER(_I)], None),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "attention_f32": {
        # B1: q, k, v, o; B, Lq, Lk, H, Dh; q/k/v/o batch and row strides;
        # exp2 constant; stream
        "packed_attention_f32": (
            [_VP] * 4 + [_I] * 5 + [_I] * 8 + [ctypes.c_float, _VP], _I),
        # B4's attention: B1's arguments (the fp32 FMA forward in the plain
        # version's summation order)
        "packed_attention_fma_f32": (
            [_VP] * 4 + [_I] * 5 + [_I] * 8 + [ctypes.c_float, _VP], _I),
        # B6a: the same with den after o
        "packed_attention_den_f32": (
            [_VP] * 5 + [_I] * 5 + [_I] * 8 + [ctypes.c_float, _VP], _I),
        # B11's attention: B1's arguments, the constant c / 127^2
        "packed_attention_qk8_f32": (
            [_VP] * 4 + [_I] * 5 + [_I] * 8 + [ctypes.c_float, _VP], _I),
        # the check of B11's codes and rescale: q, k, args; B, Lq, Lk, H,
        # Dh; q/k batch and row strides; c / 127^2; stream
        "attention_f32_qk8_args": (
            [_VP] * 3 + [_I] * 5 + [_I] * 4 + [ctypes.c_float, _VP], _I),
        # B12's attention: q, k1, v1, k2, v2, o; B, Lq, L1, L2, H, Dh;
        # q/k1/v1/k2/v2/o batch and row strides; constant; int8 QK^T?;
        # stream
        "packed_attention_2src_f32": (
            [_VP] * 6 + [_I] * 6 + [_I] * 12 + [ctypes.c_float, _I, _VP],
            _I),
        # B6b: q, k, v, do, o, den, dq, dk, dv, scratch; B, Lq, Lk, H, Dh;
        # q/k/v batch and row strides; the launch plan (lq_pad, grid,
        # accumulator in shared memory?, shared bytes); scale; stream
        "packed_attention_bwd_f32": (
            [_VP] * 10 + [_I] * 5 + [_I] * 6 + [_I] * 4
            + [ctypes.c_float, _VP], _I),
        # B8: q, k, v, do, o and den scratch, dq, dk, dv, scratch; then as
        # B6b
        "packed_attention_bwd_recompute_f32": (
            [_VP] * 10 + [_I] * 5 + [_I] * 6 + [_I] * 4
            + [ctypes.c_float, _VP], _I),
        # B7 forward: q, k, v, o, lse; B, Lq, Lk, H, Dh; q/k/v/o batch and
        # row strides; scale; causal; stream
        "streaming_attention_f32": (
            [_VP] * 5 + [_I] * 5 + [_I] * 8 + [ctypes.c_float, _I, _VP], _I),
        # B7 backward: q, k, v, do, o, lse, dq, dk, dv, scratch; B, Lq, Lk,
        # H, Dh; q/k/v batch and row strides; scale; causal; the launch
        # plan (key-tile groups, lq_pad, grid, accumulator in shared
        # memory?, shared bytes); stream
        "streaming_attention_bwd_f32": (
            [_VP] * 10 + [_I] * 5 + [_I] * 6
            + [ctypes.c_float, _I] + [_I] * 5 + [_VP], _I),
        # the launch plans' layout: fifteen ints
        "attention_f32_layout": ([ctypes.POINTER(_I)], None),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "w8a8_matmul": {
        # x, W, s, b, y; M, K, N; the launch plan (rows per block, units
        # per block, ring stages, shared bytes); stream
        "w8a8_matmul_bf16": ([_VP] * 5 + [_I] * 7 + [_VP], _I),
        # the fp32 form: x, W, s, b, r (fp32 residual or null), y; then as
        # the bf16 entry
        "w8a8_matmul_f32": ([_VP] * 6 + [_I] * 7 + [_VP], _I),
        # the plan's constants and the device's shared-memory limit: six
        # ints (the bf16 form's, the fp32 form's)
        "w8a8_matmul_layout": ([ctypes.POINTER(_I)], None),
        "w8a8_matmul_layout_f32": ([ctypes.POINTER(_I)], None),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "w8a8_qkv": {
        # x, e, Wq, Wk, Wv, sq, sk, sv, bq, bk, bv, gamma, beta, oq, ok, ov;
        # B, Lx, Le, K, N; the launch plan (rows per block, units per
        # block, ring stages, shared bytes); stream
        "w8a8_qkv_cat_bf16": ([_VP] * 16 + [_I] * 9 + [_VP], _I),
        # the fp32 form, the same arguments
        "w8a8_qkv_cat_f32": ([_VP] * 16 + [_I] * 9 + [_VP], _I),
        # the plan's constants and the device's shared-memory limit: five
        # ints
        "w8a8_qkv_layout": ([ctypes.POINTER(_I)], None),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "attention_out_int8": {
        # q, k, v, W, s, bias, r, o, fp32 scratch; B, lq, Lk, H; q/k/v
        # batch and row strides; exp2 constant; the launch plan (rows per
        # block, shared bytes); stream
        "attention_out_int8_bf16": (
            [_VP] * 9 + [_I] * 4 + [_I] * 6 + [ctypes.c_float, _I, _I, _VP],
            _I),
        # the int8 QK^T form: the constant is c / 127^2
        "attention_out_int8_qk8_bf16": (
            [_VP] * 9 + [_I] * 4 + [_I] * 6 + [ctypes.c_float, _I, _I, _VP],
            _I),
        # the two-source form: q, k1, v1, k2, v2, W, s, bias, r, o, scratch;
        # B, Lq,
        # L1, L2, H; q/k1/v1/k2/v2 batch and row strides; constant; int8
        # QK^T?; the launch plan; stream
        "attention_out_int8_2src_bf16": (
            [_VP] * 11 + [_I] * 5 + [_I] * 10 + [ctypes.c_float, _I, _I, _I,
                                                 _VP], _I),
        # the plan's constants and the device's shared-memory limit: six
        # ints
        "attention_out_int8_layout": ([ctypes.POINTER(_I)], None),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "w8a8_mlp": {
        # x, W1, s1, b1, W2, s2, b2, gamma, beta, r, y, hidden-code scratch;
        # M, K, H, N; the launch plan (rows per block, fc2 stages, shared
        # bytes); stream
        "w8a8_mlp_res_bf16": ([_VP] * 12 + [_I] * 7 + [_VP], _I),
        # without the residual (gamma, beta may be null: no LayerNorm)
        "w8a8_mlp_bf16": ([_VP] * 11 + [_I] * 7 + [_VP], _I),
        # the plan's constants and the device's shared-memory limit: seven
        # ints
        "w8a8_mlp_layout": ([ctypes.POINTER(_I)], None),
        # the reciprocal check: a device uint64 counter; stream
        "w8a8_mlp_rcp_check": ([_VP, _VP], _I),
        # the QuickGELU check: three device uint64; stream
        "w8a8_mlp_qgelu_check": ([_VP, _VP], _I),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "w8a8_mlp_f32": {
        # the fp32 forms of w8a8_mlp's entries, the same arguments
        "w8a8_mlp_res_f32": ([_VP] * 12 + [_I] * 7 + [_VP], _I),
        "w8a8_mlp_f32": ([_VP] * 11 + [_I] * 7 + [_VP], _I),
        "w8a8_mlp_layout": ([ctypes.POINTER(_I)], None),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "w8_matmul": {
        # x, W^T, scale, y; M, K, N; stream
        "w8_matmul_bf16": ([_VP] * 4 + [_I] * 3 + [_VP], _I),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "w8_matmul_f32": {
        # the fp32 form, the same arguments
        "w8_matmul_f32": ([_VP] * 4 + [_I] * 3 + [_VP], _I),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "fused_extras": {
        # cls, cls row stride; Wc, bc, lns, lnb, Wq, bq, Wk, bk, Wv, bv, Wo,
        # bo, lp, gp; e, summary, workspace; Bb, Tb, G, D, H, le_pad;
        # weights bf16?, activations bf16?; the launch plan (blocks a
        # cluster, clusters); stream
        "fused_extras": ([_VP, ctypes.c_longlong] + [_VP] * 17 + [_I] * 10
                         + [_VP], _I),
        # the plan's constants: eight ints
        "fused_extras_layout": ([ctypes.POINTER(_I)], None),
        # the most resident clusters of CS blocks (bf16 weights?)
        "fused_extras_max_clusters": ([_I, _I], _I),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "mega_layer": {
        # x, e; W^T of q, k, v, out, fc1, fc2; scales of q, k, v, out;
        # their biases; s1, b1, s2, b2; LayerNorm 1 and 2 gamma, beta; y,
        # workspace; F, Lx, Le, D, hidden, heads, CTAs per frame row; stream
        "mega_layer_bf16": ([_VP] * 26 + [_I] * 7 + [_VP], _I),
        # workspace bytes of F frame rows: F, Lx, Le, D, hidden
        "mega_layer_workspace": ([_I] * 5, ctypes.c_longlong),
        "cuda_error_string": ([_I], ctypes.c_char_p),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per kernel source: seconds the build took (0.0 when a cached .so was
# loaded) and the compiler's output (ptxas register / spill report)
build_info: Dict[str, Dict] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ at first use and need the CUDA toolkit")


def _build(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}_{digest}.so"
    if so.is_file():
        build_info.setdefault(name, {"seconds": 0.0, "log": "",
                                     "so": str(so)})
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(src)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src} ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, so)
    build_info[name] = {"seconds": secs, "log": res.stdout + res.stderr,
                        "so": str(so)}
    return so


def load_libraries(names: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Build every source not built yet in parallel (one nvcc each), then
    load them all."""
    todo = [n for n in names if n not in _libs]
    with ThreadPoolExecutor(max(1, len(todo))) as ex:
        list(ex.map(_build, todo))
    return {n: load_library(n) for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """The bound library built from csrc/<name>.cu (built at first use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_build(name)))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return _libs[name]
