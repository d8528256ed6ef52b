"""The float32 attention kernels (csrc/attention_f32.cu) run on the CPU:
the CUDA source compiled with g++ against a small emulation of the CUDA
features it uses (one std::thread per CUDA thread, a block's threads
meeting at a std::barrier, warp shuffles through a block-wide buffer,
shared memory filled with NaN before each launch) and called through the
same C entry points and ctypes signatures as on the card. Held against the
plain versions at small ragged shapes with chip_smoke's fp32 limit, with
their fp32 mutants (utils/kernel_mutants.py) rejected by the same limit.
ex2.approx becomes exp2f here, so this checks the kernels' indexing,
masking, tiling and summation, not the card's instructions.

Also the dtype rules of the attention wrappers: q/k/v all bfloat16 or all
float32, and fp32 into a kernel without an fp32 form raises naming its
ROADMAP item.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from gava_clip_tpu_torch.ops import _cuda
from gava_clip_tpu_torch.ops import flash_attention as tfa
from gava_clip_tpu_torch.utils import kernel_mutants

# chip_smoke.F32_REL: fp32 summation order and exp2, ~1e-6 of the scale; a
# TF32 product ~1e-3
F32_REL = 2.0 ** -14

_EMU_HEADER = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n)
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx;
inline uint3 blockIdx, gridDim;
inline std::barrier<>* g_bar = nullptr;
inline std::vector<float> g_smem_buf, g_shfl(1024);
inline float* g_smem = nullptr;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float x, int off) {
  g_shfl[threadIdx.x] = x;
  __syncthreads();
  float y = g_shfl[threadIdx.x ^ off];
  __syncthreads();
  return y;
}
inline float __uint_as_float(unsigned x) { float f; std::memcpy(&f, &x, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned x; std::memcpy(&x, &f, 4); return x; }
inline int min(int a, int b) { return a < b ? a : b; }
template <class K, class A>
void emu_launch(K k, dim3 grid, int threads, int smem_bytes, const A& a) {
  gridDim = {grid.x, grid.y, grid.z};
  g_smem_buf.assign(smem_bytes / 4, std::nanf(""));
  g_smem = g_smem_buf.data();
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = {x, y, z};
        std::barrier<> bar(threads);
        g_bar = &bar;
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
          ts.emplace_back([&, t] { threadIdx = {unsigned(t), 0, 0}; k(a); });
        for (auto& th : ts) th.join();
      }
}
"""


def _split_top(text):
    out, depth, cur = [], 0, ""
    for ch in text:
        depth += ch in "(<"
        depth -= ch in ")>"
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return out + [cur.strip()]


def _emulated(src: str) -> str:
    """The CUDA source as C++ for the emulation header: dynamic shared
    memory from the launch's buffer, exp2f for ex2.approx, each
    `kernel<<<grid, threads, smem, stream>>>(args)` an emu_launch."""
    src = src.replace("extern __shared__ __align__(16) float smem[];",
                      "float* smem = g_smem;")
    src = src.replace('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : '
                      '"f"(x));', "y = exp2f(x);")
    while "<<<" in src:
        i = src.index("<<<")
        j = src.index(">>>", i)
        start = max(src.rfind(c, 0, i) for c in ";{}") + 1
        grid, threads, smem, _ = _split_top(src[i + 3:j])
        m = re.match(r"\((\w+)\)", src[j + 3:])
        src = (src[:start] + f"\n  emu_launch({src[start:i].strip()}, {grid}, "
               f"{threads}, {smem}, {m.group(1)})" + src[j + 3 + m.end():])
    assert "asm(" not in src and "__shared__" not in src
    return src


def _build(tmp, name, src):
    (tmp / "cuda_runtime.h").write_text(_EMU_HEADER)
    (tmp / f"{name}.cpp").write_text(_emulated(src))
    so = tmp / f"lib{name}.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(tmp), "-o", str(so),
                    str(tmp / f"{name}.cpp")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in _cuda._SIGNATURES["attention_f32"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


_SOURCE = _cuda.CSRC / "attention_f32.cu"


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the emulation")
    tmp = tmp_path_factory.mktemp("attention_f32_emu")
    return tmp, _build(tmp, "kernel", _SOURCE.read_text())


def _inputs(seed, B, Lq, Lk, H, sliced):
    """q, k, v, do drawn with numpy; `sliced`: q, k, v as column views of
    one (B, L, 3D) projection (row stride 3D)."""
    rs = np.random.RandomState(seed)
    D = H * 64
    if sliced:
        qkv = torch.from_numpy(rs.randn(B, max(Lq, Lk), 3 * D)
                               .astype(np.float32))
        q, k, v = qkv[:, :Lq, :D], qkv[:, :Lk, D:2 * D], qkv[:, :Lk, 2 * D:]
    else:
        q, k, v = (torch.from_numpy(rs.randn(B, L, D).astype(np.float32))
                   for L in (Lq, Lk, Lk))
    do = torch.from_numpy(rs.randn(B, Lq, D).astype(np.float32))
    return q, k, v, do


def _run(lib, B, Lq, Lk, H, causal=None, sliced=False, seed=0):
    """Every entry at one shape against its plain version: {check: max err
    / scale} (forward: sum p |v|; backward: the tensor's largest |value|),
    den's relative and lse's absolute error, and the bit equalities."""
    q, k, v, do = _inputs(seed, B, Lq, Lk, H, sliced)
    D, Dh = H * 64, 64
    strides = tfa._qkv_strides(q, k, v)
    P = torch.Tensor.data_ptr

    def grads():
        return [torch.empty(B, L, D) for L in (Lq, Lk, Lk)]

    def rel(a, b, scale):
        return ((a - b).abs() / scale).max().item()

    def rel_grads(got, want):
        return max(rel(a, b, b.abs().max()) for a, b in zip(got, want))

    scratch = torch.empty(2 * B * H * Lq)
    res = {}
    if causal is None:
        c = Dh ** -0.5 * tfa._LOG2E
        o, o1 = torch.empty(B, Lq, D), torch.empty(B, Lq, D)
        den = torch.empty(B, Lq, H)
        assert lib.packed_attention_den_f32(
            P(q), P(k), P(v), P(o), P(den), B, Lq, Lk, H, Dh, *strides,
            o.stride(0), o.stride(1), c, None) == 0
        assert lib.packed_attention_f32(
            P(q), P(k), P(v), P(o1), B, Lq, Lk, H, Dh, *strides, o1.stride(0),
            o1.stride(1), c, None) == 0
        ref, den_ref = tfa.packed_attention_den_plain(q, k, v, H)
        spread = tfa.packed_attention_plain(q, k, v.abs(), H)
        res["packed_attention_den_f32"] = rel(o, ref, spread)
        res["packed_attention_f32"] = rel(o1, ref, spread)
        res["den"] = ((den - den_ref).abs() / den_ref).max().item()
        g, g8, g6 = grads(), grads(), grads()
        assert lib.packed_attention_bwd_f32(
            P(q), P(k), P(v), P(do), P(ref), P(den_ref), *map(P, g),
            P(scratch), B, Lq, Lk, H, Dh, *strides, Dh ** -0.5, None) == 0
        res["packed_attention_bwd_f32"] = rel_grads(
            g, tfa.packed_attention_bwd_plain(q, k, v, do, ref, den_ref, H))
        o8, den8 = torch.empty(B, Lq, D), torch.empty(B, Lq, H)
        assert lib.packed_attention_bwd_recompute_f32(
            P(q), P(k), P(v), P(do), P(o8), P(den8), *map(P, g8), P(scratch),
            B, Lq, Lk, H, Dh, *strides, Dh ** -0.5, None) == 0
        res["packed_attention_bwd_recompute_f32"] = rel_grads(
            g8, tfa.packed_attention_bwd_recompute_plain(q, k, v, do, H))
        # B8 = the forward kernel, then B6b's kernels on its o and den
        assert lib.packed_attention_bwd_f32(
            P(q), P(k), P(v), P(do), P(o), P(den), *map(P, g6), P(scratch),
            B, Lq, Lk, H, Dh, *strides, Dh ** -0.5, None) == 0
        res["bits"] = torch.equal(o, o1) and all(
            torch.equal(a, b) for a, b in zip(g8, g6))
    else:
        o, lse = torch.empty(B, Lq, D), torch.empty(B, H, Lq)
        assert lib.streaming_attention_f32(
            P(q), P(k), P(v), P(o), P(lse), B, Lq, Lk, H, Dh, *strides,
            o.stride(0), o.stride(1), Dh ** -0.5, int(causal), None) == 0
        ref, lse_ref = tfa.streaming_attention_plain(q, k, v, H, causal)
        spread = tfa.streaming_attention_plain(q, k, v.abs(), H, causal)[0]
        res["streaming_attention_f32"] = rel(o, ref, spread)
        res["lse"] = (lse - lse_ref).abs().max().item()
        g = grads()
        assert lib.streaming_attention_bwd_f32(
            P(q), P(k), P(v), P(do), P(ref), P(lse_ref), *map(P, g),
            P(scratch), B, Lq, Lk, H, Dh, *strides, Dh ** -0.5, int(causal),
            None) == 0
        res["streaming_attention_bwd_f32"] = rel_grads(
            g, tfa.streaming_attention_bwd_plain(q, k, v, do, ref, lse_ref, H,
                                                 causal))
        res["bits"] = True
    return res


# (B, Lq, Lk, H, causal or None for the packed kernels, sliced q/k/v):
# ragged tiles, more query than key tiles and the reverse, causal with Lq
# above and below Lk, q/k/v as views of one projection
_SHAPES = [(2, 13, 21, 2, None, False), (1, 70, 130, 1, None, False),
           (1, 65, 64, 2, None, True), (1, 77, 77, 2, True, False),
           (1, 130, 70, 1, True, True), (1, 40, 150, 1, False, False)]


@pytest.mark.parametrize("shape", _SHAPES)
def test_f32_kernels_match_plain_versions(emu, shape):
    _, lib = emu
    *dims, causal, sliced = shape
    res = _run(lib, *dims, causal=causal, sliced=sliced)
    for name, err in res.items():
        if name.endswith("_f32"):
            assert err <= F32_REL, (name, err)
    assert res.get("den", 0.0) <= 2.0 ** -16
    assert res.get("lse", 0.0) <= 3e-5
    assert res["bits"]


@pytest.mark.parametrize("name", [n for n in kernel_mutants.MUTANTS
                                  if n.startswith("f32_")])
def test_f32_mutants_fail_the_limit(emu, name):
    """Each fp32 mutant, built from the source with the mutant's own edits,
    breaks the limit of the kernel it targets at one of the shapes."""
    tmp, _ = emu
    path, edits, _, word = kernel_mutants.MUTANTS[name]
    assert path.endswith(_SOURCE.name)
    src = _SOURCE.read_text()
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    lib = _build(tmp, name, src)
    target = word.split()[0]
    worst = 0.0
    for shape in _SHAPES:
        *dims, causal, sliced = shape
        if (causal is None) != target.startswith("packed"):
            continue
        worst = max(worst, _run(lib, *dims, causal=causal,
                                sliced=sliced)[target])
    assert worst > F32_REL, (name, worst)


def test_attention_wrappers_take_bf16_or_fp32_and_refuse_the_rest():
    """The dtype rules hold before any device work: all bfloat16 or all
    float32 (then a CPU tensor is refused for want of a card), mixed or
    half inputs raise TypeError, and fp32 into the w8a8 attention +
    out-projection (no fp32 form) raises naming its ROADMAP item."""
    x = torch.zeros(1, 5, 128)
    for dtype in (torch.float32, torch.bfloat16):
        t = x.to(dtype)
        with pytest.raises(ValueError, match="CUDA"):
            tfa.packed_attention_cuda(t, t, t, 2)
    with pytest.raises(TypeError, match="all bfloat16 or all float32"):
        tfa.packed_attention_den_cuda(x, x.bfloat16(), x, 2)
    with pytest.raises(TypeError, match="all bfloat16 or all float32"):
        tfa.streaming_attention_cuda(x.half(), x.half(), x.half(), 2, True)
    op = {"kernel": {"qa": torch.zeros(128, 128, dtype=torch.int8),
                     "scale": torch.ones(1, 128)}, "bias": torch.zeros(128)}
    with pytest.raises(TypeError, match="ROADMAP A12"):
        tfa.attention_out_int8_cuda(x, x, x, 2, op, x)
    with pytest.raises(TypeError, match="ROADMAP A12"):
        tfa.attention_out_int8_2src_cuda(x, x, x, x, x, 2, op, x)
    assert set(tfa.launch_counts.values()) == {0}
