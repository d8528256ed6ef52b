"""The float32 attention kernels (csrc/attention_f32.cu) run on the CPU:
the CUDA source compiled with g++ against a small emulation of the CUDA
features it uses (one std::thread per CUDA thread, a block's threads
meeting at a std::barrier, a warp's at one of its own for its shuffles and
its mma.sync, shared memory filled with NaN before each launch) and called
through the same C entry points and ctypes signatures as on the card. The
PTX of csrc/tf32_frags.cuh becomes C++: mma.sync m16n8k8 TF32 in its
fragment layout with each operand cut to its top 19 bits, wgmma m64n128k8
TF32 (csrc/w8_matmul_f32.cu's, tests/test_torch_w8_f32.py) as those
products over its descriptor's unswizzled core matrices, cp.async a plain
copy (its waits and the fences no-ops); that product is held against numpy.
The kernels are held against the plain versions at small ragged shapes
with chip_smoke's fp32 limit, with their fp32 mutants
(utils/kernel_mutants.py) rejected by the same limit; B7's forward (the
3xTF32 forward's kernel in its streaming form, at every length) is also held
directly against JAX's streaming forward and, by its RMS error, at least as
close to a float64 causal attention as the plain fp32 version; B7's backward
at rows up to 128 takes its one-launch form (the 3xTF32 backward's kernel in
its streaming form), gives the same bits twice and is also held directly
against JAX's gradient. ex2.approx becomes exp2f here, so this checks the
kernels' indexing, masking, tiling and summation, not the card's
instructions.

The same for the forms the w8a8 serving fusion's fp32 path adds: the
int8-score form (B11), whose codes and exp2 arguments (the check entry
`attention_f32_qk8_args`) equal the plain version's bit for bit on random
rows and on rows whose values sit on the codes' rounding ties, and the
two-source form (B12), equal bit for bit to the one-source forms on the
concatenated keys; their mutants fail those checks.

Also the dtype rules of the attention wrappers: q/k/v all bfloat16 or all
float32 (every form, B11 and B12 included, takes both), fp16 or mixed
raise TypeError.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from gava_clip_tpu_torch.ops import _cuda
from gava_clip_tpu_torch.ops import flash_attention as tfa
from gava_clip_tpu_torch.utils import kernel_mutants
from tests.test_torch_bounds import module_deadline  # noqa: F401

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
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n)
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
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
// a warp's exchange buffers: shuffles, and the fragments of its mma (two
// sets, used in turns, so that one barrier an mma suffices)
struct EmuWarp {
  std::barrier<> bar{32};
  float shfl[32];
  uint32_t a[2][32][4], b[2][32][2];
  int phase[32] = {};
};
inline std::vector<EmuWarp>* g_warps = nullptr;
inline std::vector<float> g_smem_buf;
inline float* g_smem = nullptr;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
// a shared-memory address: the offset into the launch's buffer (what a
// wgmma descriptor holds)
inline size_t __cvta_generic_to_shared(const void* p) {
  return static_cast<size_t>(static_cast<const char*>(p) - reinterpret_cast<const char*>(g_smem));
}
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline EmuWarp& emu_warp() { return (*g_warps)[threadIdx.x >> 5]; }
inline float __shfl_xor_sync(unsigned, float x, int off) {
  EmuWarp& w = emu_warp();
  const unsigned lane = threadIdx.x & 31;
  w.shfl[lane] = x;
  w.bar.arrive_and_wait();
  const float y = w.shfl[lane ^ off];
  w.bar.arrive_and_wait();
  return y;
}
inline float __shfl_sync(unsigned, float x, int src) {
  EmuWarp& w = emu_warp();
  const unsigned lane = threadIdx.x & 31;
  w.shfl[lane] = x;
  w.bar.arrive_and_wait();
  const float y = w.shfl[src & 31];
  w.bar.arrive_and_wait();
  return y;
}
inline float __uint_as_float(unsigned x) { float f; std::memcpy(&f, &x, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned x; std::memcpy(&x, &f, 4); return x; }
inline int min(int a, int b) { return a < b ? a : b; }
// mma.sync m16n8k8 TF32 -> fp32 as a warp-scoped collective: each lane
// leaves its fragments, then takes its four outputs from the PTX fragment
// layout, each operand cut to its top 19 bits (what the tensor core
// reads), the eight products (exact) summed with the accumulator in
// double and truncated once toward zero (the tensor core truncates the sum
// it accumulates; a chain of mma into one accumulator drifts so)
inline void emu_mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31, ph = w.phase[lane];
  w.phase[lane] ^= 1;
  for (int i = 0; i < 4; ++i) w.a[ph][lane][i] = a[i];
  w.b[ph][lane][0] = b0;
  w.b[ph][lane][1] = b1;
  w.bar.arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    double s = d[i];
    for (int k = 0; k < 8; ++k) {
      const uint32_t av = w.a[ph][(row & 7) * 4 + (k & 3)][(row >> 3) + 2 * (k >> 2)];
      const uint32_t bv = w.b[ph][col * 4 + (k & 3)][k >> 2];
      s += static_cast<double>(__uint_as_float(av & 0xffffe000u)) *
           __uint_as_float(bv & 0xffffe000u);
    }
    float f = static_cast<float>(s);
    if (std::fabs(static_cast<double>(f)) > std::fabs(s)) f = std::nextafter(f, 0.f);
    d[i] = f;
  }
}
// mma.sync m16n8k32 s8 x s8 -> s32 as the same collective: each output the
// exact integer sum of its 32 byte products added to the accumulator
inline void emu_mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31, ph = w.phase[lane];
  w.phase[lane] ^= 1;
  for (int i = 0; i < 4; ++i) w.a[ph][lane][i] = a[i];
  w.b[ph][lane][0] = b0;
  w.b[ph][lane][1] = b1;
  w.bar.arrive_and_wait();
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    long long s = d[i];
    for (int k = 0; k < 32; ++k) {
      const uint32_t av = w.a[ph][(row & 7) * 4 + ((k & 15) >> 2)][(row >> 3) + 2 * (k >> 4)];
      const uint32_t bv = w.b[ph][col * 4 + ((k & 15) >> 2)][k >> 4];
      s += static_cast<int>(static_cast<int8_t>(av >> (8 * (k & 3)))) *
           static_cast<int>(static_cast<int8_t>(bv >> (8 * (k & 3))));
    }
    d[i] = static_cast<int>(s);
  }
}
// wgmma m64nNk8 TF32 with A from registers (N = 2 R): each warp of the
// warpgroup its own 16 rows, as N / 8 m16n8k8 products of its A fragment and
// the 8-column slices of B, read from shared memory by the descriptor
// (unswizzled, k-major: core matrices of 8 rows x 16 bytes, lbo bytes apart
// along k, sbo along the rows); `acc` false starts a fresh sum (scale-d 0)
template <int R>
inline void emu_wgmma_tf32(float (&d)[R], const uint32_t (&a)[4], uint64_t desc, bool acc) {
  if ((desc >> 62) != 0) std::abort();   // a swizzled layout: not emulated
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const char* base = reinterpret_cast<const char*>(g_smem) + ((desc & 0x3FFFu) << 4);
  const size_t lbo = ((desc >> 16) & 0x3FFFu) << 4, sbo = ((desc >> 32) & 0x3FFFu) << 4;
  for (int j = 0; j < R / 4; ++j) {
    const char* at = base + j * sbo + g * 16 + t * 4;   // B (k t, column 8 j + g)
    uint32_t b0, b1;
    std::memcpy(&b0, at, 4);
    std::memcpy(&b1, at + lbo, 4);
    float dj[4];
    for (int i = 0; i < 4; ++i) dj[i] = acc ? d[4 * j + i] : 0.f;
    emu_mma_tf32(dj, a, b0, b1);
    for (int i = 0; i < 4; ++i) d[4 * j + i] = dj[i];
  }
}
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
        std::vector<EmuWarp> warps(threads / 32);
        g_warps = &warps;
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
          ts.emplace_back([&, t] { threadIdx = {unsigned(t), 0, 0}; k(a); });
        for (auto& th : ts) th.join();
      }
}
"""

# csrc/tf32_frags.cuh's PTX, one named function each, as C++: cp.async as
# a plain copy (zeros when nothing is read) with its commit and waits as
# no-ops, mma.sync as the collectives above (TF32, with its accumulator
# cleared first where the statement binds it to zeros: mma_tf32_z; s8),
# wgmma as the emulation above run at once (fresh where the statement's
# accumulator is write-only: wgmma_tf32_z), its fences, commit and wait and
# the proxy fence as no-ops
_MMA = "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32"
_MMA_S8 = "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32"
_WGMMA = "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32"
_PTX_EMULATION = {
    "cp.async.cg.shared.global": "if (ok) std::memcpy(dst, src, 16); "
                                 "else std::memset(dst, 0, 16);",
    "cp.async.commit_group": "",
    "cp.async.wait_group 0": "",
    "cp.async.wait_group 1": "",
    _MMA: "emu_mma_tf32(d, a, b0, b1);",
    _MMA + " (zero accumulator)":
        "d[0] = d[1] = d[2] = d[3] = 0.f; emu_mma_tf32(d, a, b0, b1);",
    _MMA_S8: "emu_mma_s8(d, a, b0, b1);",
    "fence.proxy.async.shared::cta": "",
    "wgmma.fence.sync.aligned": "",
    "wgmma.commit_group.sync.aligned": "",
    "wgmma.wait_group.sync.aligned 0": "",
    _WGMMA: "emu_wgmma_tf32(d, a, desc, true);",
    _WGMMA + " (zero accumulator)": "emu_wgmma_tf32(d, a, desc, false);",
}


def _emulated_header(src: str) -> str:
    """tf32_frags.cuh with each PTX statement replaced by its emulation."""
    def sub(m):
        stmt = m.group(0)
        if re.match(r'asm(?:\s+volatile)?\(""', stmt):   # tf32::pin: no code
            return ";"
        ptx = [k for k in _PTX_EMULATION if f'"{k.split(" (")[0]}' in stmt]
        if _MMA in ptx:
            ptx = [_MMA + " (zero accumulator)" if '"f"(0.f)' in stmt
                   else _MMA]
        if _WGMMA in ptx:
            ptx = [_WGMMA + " (zero accumulator)" if "TF32_W)" in stmt
                   else _WGMMA]
        assert len(ptx) == 1, stmt
        return _PTX_EMULATION[ptx[0]]
    out = re.sub(r"asm(?:\s+volatile)?\(.*?\);", sub, src, flags=re.S)
    assert "asm" not in out
    return out


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


# What the int8-score form (and csrc/w8_matmul_f32.cu) uses beyond the
# header: the _rn intrinsics as one fp32 operation each (g++ contracts
# nothing into an FMA for x86-64 without -mfma), the 16-byte integer vector.
# Kept out of _EMU_HEADER, which tests/test_torch_w8a8_rows.py extends with
# its own definitions of these.
_EMU_EXTRA = r"""
#include "cuda_runtime.h"
#define __restrict__
struct uint4 { unsigned x, y, z, w; };
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __frcp_rn(float a) { return 1.0f / a; }
inline float __fsub_rn(float a, float b) { return a - b; }
// byte i of the result: byte (s >> 4 i & 7) of y:x
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long v = (static_cast<unsigned long long>(y) << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i) r |= ((v >> (8 * ((s >> (4 * i)) & 7))) & 0xffu) << (8 * i);
  return r;
}
"""


def _build(tmp, name, src, library="attention_f32"):
    """The emulated source as a shared library bound with `library`'s
    ctypes signatures."""
    (tmp / "cuda_runtime.h").write_text(_EMU_HEADER)
    (tmp / "tf32_frags.cuh").write_text(
        _emulated_header((_cuda.CSRC / "tf32_frags.cuh").read_text()))
    (tmp / f"{name}.cpp").write_text(_EMU_EXTRA + _emulated(src))
    so = tmp / f"lib{name}.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(tmp), "-o", str(so),
                    str(tmp / f"{name}.cpp")], check=True, capture_output=True,
                   timeout=300)
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in _cuda._SIGNATURES[library].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


_SOURCE = _cuda.CSRC / "attention_f32.cu"


# CPUs the emulated launches run on: a block's hundreds of threads meet at
# a barrier for every mma, and the threads a launch starts inherit the
# affinity of the thread that calls it, so the module keeps them on two CPUs
# and leaves the others to whatever runs beside it
_EMU_CPUS = 2


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the emulation")
    tmp = tmp_path_factory.mktemp("attention_f32_emu")
    lib = _build(tmp, "kernel", _SOURCE.read_text())
    cpus = os.sched_getaffinity(0)
    os.sched_setaffinity(0, set(sorted(cpus)[:_EMU_CPUS]))
    try:
        yield tmp, lib
    finally:
        os.sched_setaffinity(0, cpus)


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


def _stream_bwd(lib, q, k, v, do, o, lse, H, causal, **plan_kw):
    """B7's fp32 backward through the entry in the form of its plan
    (`plan_kw`: attention_f32_plan's sm_count or groups): (dq, dk, dv), the
    plan."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    plan = tfa.attention_f32_plan(B, Lq, Lk, H, packed=False,
                                  causal=causal, **plan_kw)["bwd"]
    scratch = torch.full((max(plan["scratch_floats"], 1),), float("nan"))
    g = [torch.empty(B, L, D) for L in (Lq, Lk, Lk)]
    P = torch.Tensor.data_ptr
    assert lib.streaming_attention_bwd_f32(
        P(q), P(k), P(v), P(do), P(o), P(lse), *map(P, g),
        P(scratch) if plan["scratch_floats"] else None, B, Lq, Lk, H, 64,
        *tfa._qkv_strides(q, k, v), 64 ** -0.5, int(causal), plan["groups"],
        plan["lq_pad"], plan["grid"], int(plan["acc_in_smem"]),
        plan["smem_bytes"], None) == 0
    return g, plan


def _run(lib, B, Lq, Lk, H, causal=None, sliced=False, seed=0):
    """Every entry at one shape against its plain version: {check: max err
    / scale} (forward: sum p |v|; backward: the tensor's largest |value|),
    den's relative and lse's absolute error, and the bit equalities (the
    streaming backward: two runs give the same bits)."""
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

    res = {}
    if causal is None:
        plan = tfa.attention_f32_plan(B, Lq, Lk, H)["bwd"]
        bwd_scratch = torch.empty(max(plan["scratch_floats"], 1))
        bwd_plan = (plan["lq_pad"], plan["grid"], int(plan["acc_in_smem"]),
                    plan["smem_bytes"])
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
            P(bwd_scratch), B, Lq, Lk, H, Dh, *strides, *bwd_plan,
            Dh ** -0.5, None) == 0
        res["packed_attention_bwd_f32"] = rel_grads(
            g, tfa.packed_attention_bwd_plain(q, k, v, do, ref, den_ref, H))
        o8, den8 = torch.empty(B, Lq, D), torch.empty(B, Lq, H)
        assert lib.packed_attention_bwd_recompute_f32(
            P(q), P(k), P(v), P(do), P(o8), P(den8), *map(P, g8),
            P(bwd_scratch), B, Lq, Lk, H, Dh, *strides, *bwd_plan,
            Dh ** -0.5, None) == 0
        res["packed_attention_bwd_recompute_f32"] = rel_grads(
            g8, tfa.packed_attention_bwd_recompute_plain(q, k, v, do, H))
        # B8 = the forward kernel, then B6b's kernel on its o and den
        assert lib.packed_attention_bwd_f32(
            P(q), P(k), P(v), P(do), P(o), P(den), *map(P, g6),
            P(bwd_scratch), B, Lq, Lk, H, Dh, *strides, *bwd_plan,
            Dh ** -0.5, None) == 0
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
        g, plan = _stream_bwd(lib, q, k, v, do, ref, lse_ref, H, causal)
        res["form"] = plan["form"]
        res["streaming_attention_bwd_f32"] = rel_grads(
            g, tfa.streaming_attention_bwd_plain(q, k, v, do, ref, lse_ref, H,
                                                 causal))
        again = _stream_bwd(lib, q, k, v, do, ref, lse_ref, H, causal)[0]
        res["bits"] = all(torch.equal(a, b) for a, b in zip(g, again))
    return res


# (B, Lq, Lk, H, causal or None for the packed kernels, sliced q/k/v):
# ragged tiles, more query than key tiles and the reverse, causal with Lq
# above and below Lk, q/k/v as views of one projection; then query rows
# that are not a multiple of 16 with keys that are not a multiple of 8 past
# a backward key tile (128) and inside a forward one (64), and Lq past 240,
# whose backward keeps its dq accumulator in the global scratch; then B7's
# forward causal over three key tiles with Lq < Lk, neither a multiple of
# 16 or 8 (its blocks stop at their last row's tile, its warps at their
# last row's chunk); then B7's backward past 128 rows non-causal over three
# key tiles (the last of 14 keys), and causal with key tiles past every
# query row (each still writes its dk, dv: zeros)
_SHAPES = [(2, 13, 21, 2, None, False), (1, 70, 130, 1, None, False),
           (1, 65, 64, 2, None, True), (1, 77, 77, 2, True, False),
           (1, 130, 70, 1, True, True), (1, 40, 150, 1, False, False),
           (1, 33, 139, 1, None, False), (1, 250, 20, 1, None, False),
           (1, 150, 170, 1, True, False), (1, 140, 270, 1, False, False),
           (1, 60, 300, 1, True, False)]


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
    if causal is not None:   # B7's backward past 128 rows: the new form
        assert res["form"] == ("one_launch" if max(dims[1:3]) <= 128
                               else "key_groups")


# (B, Lq, Lk, H, causal): B7's backward in its one-launch form (rows up to
# 128): ragged, more keys than query rows, and causal with query rows that
# are not a multiple of 16 over keys past one 32-row query tile
_ONE_LAUNCH_SHAPES = [(2, 13, 21, 2, False), (1, 40, 40, 2, True)]


@pytest.mark.parametrize("shape", _ONE_LAUNCH_SHAPES)
def test_f32_stream_bwd_one_launch_matches_plain_version(emu, shape):
    """B7's fp32 backward at rows up to 128 takes its plan's one launch (the
    3xTF32 backward's kernel in its streaming form) and stays within
    F32_REL of streaming_attention_bwd_plain, with the same bits on two
    runs."""
    *dims, causal = shape
    res = _run(emu[1], *dims, causal=causal)
    assert res["form"] == "one_launch"
    assert res["streaming_attention_bwd_f32"] <= F32_REL, res
    assert res["bits"]


def test_f32_stream_bwd_one_launch_against_jax_grad(emu):
    """The one-launch form held directly against JAX's gradient, as
    tests/test_torch_flash_train.py takes it: jax.vjp of the JAX streaming
    path (the stock Pallas TPU kernels in interpret mode) within the JAX
    package's own tolerance for them (tests/test_flash_attention.py: atol
    2e-3), and of the JAX reference attention within 1e-4 (fp32 sums in
    another order). The kernel reads o and lse from the port's plain
    streaming forward."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from gava_clip_tpu.ops import flash_attention as jflash
    B, L, H = 1, 40, 2
    q, k, v, do = _inputs(12, B, L, L, H, False)
    o, lse = tfa.streaming_attention_plain(q, k, v, H, True)
    g, plan = _stream_bwd(emu[1], q, k, v, do, o, lse, H, True)
    assert plan["form"] == "one_launch"
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: jflash._streaming_flash(
            a, b, c, H, True), jq, jk, jv)
        g_j = vjp(jdo)
    _, vjp_r = jax.vjp(lambda a, b, c: jflash._reference_attention(
        a, b, c, H, causal=True), jq, jk, jv)
    g_r = vjp_r(jdo)
    for name, gt, gj, gr in zip("qkv", g, g_j, g_r):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=2e-3,
                                   err_msg=name)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gr), atol=1e-4,
                                   err_msg=name)


# (B, Lq, Lk, H, causal): B7's backward past 128 rows in each plan it may
# take: key tiles in groups of one, two or all (one launch, the block
# owning dq; or the groups' dq sums added by the second launch), and one
# group with the dq accumulator past shared memory (Lq 250) walked by fewer
# blocks than (batch row, head) pairs
_GROUP_SHAPES = [(1, 140, 270, 1, False), (2, 250, 70, 1, True)]


@pytest.mark.parametrize("shape", _GROUP_SHAPES)
def test_f32_stream_bwd_key_groups_match_plain_version(emu, shape):
    """B7's fp32 backward past 128 rows takes the key groups' form in every
    group count and grid its plan allows, each within F32_REL of
    streaming_attention_bwd_plain and giving the same bits twice."""
    B, Lq, Lk, H, causal = shape
    q, k, v, do = _inputs(5, B, Lq, Lk, H, False)
    o, lse = tfa.streaming_attention_plain(q, k, v, H, causal)
    want = tfa.streaming_attention_bwd_plain(q, k, v, do, o, lse, H, causal)
    key_tiles = -(-Lk // tfa._F32_LAYOUT[0])
    plans = [dict(groups=g) for g in sorted({1, 2, key_tiles})]
    if Lq > 240:   # one group, the accumulator global, one block
        plans = [dict(groups=1, sm_count=1)]
    for kw in plans:
        g, plan = _stream_bwd(emu[1], q, k, v, do, o, lse, H, causal, **kw)
        assert plan["form"] == "key_groups"
        assert plan["launches"] == (1 if plan["groups"] == 1 else 2)
        if kw.get("sm_count") == 1:
            assert not plan["acc_in_smem"] and plan["grid"] == 1 < B * H
        for a, b in zip(g, want):
            assert ((a - b).abs() / b.abs().max()).max().item() <= F32_REL, kw
        again = _stream_bwd(emu[1], q, k, v, do, o, lse, H, causal, **kw)[0]
        assert all(torch.equal(a, b) for a, b in zip(g, again)), kw


def test_f32_stream_bwd_key_groups_against_jax_grad(emu):
    """The new form past 128 rows, in one group and in one a key tile,
    held directly against JAX's gradient as the one-launch form is: jax.vjp
    of the JAX streaming path (the stock Pallas TPU kernels in interpret
    mode) within the JAX package's tolerance for them (atol 2e-3), and of
    the JAX reference attention within 1e-4."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from gava_clip_tpu.ops import flash_attention as jflash
    B, L, H = 1, 150, 1
    q, k, v, do = _inputs(13, B, L, L, H, False)
    o, lse = tfa.streaming_attention_plain(q, k, v, H, False)
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a, b, c: jflash._streaming_flash(
            a, b, c, H, False), jq, jk, jv)
        g_j = vjp(jdo)
    _, vjp_r = jax.vjp(lambda a, b, c: jflash._reference_attention(
        a, b, c, H, causal=False), jq, jk, jv)
    g_r = vjp_r(jdo)
    for groups in (1, 2):
        g, plan = _stream_bwd(emu[1], q, k, v, do, o, lse, H, False,
                              groups=groups)
        assert (plan["form"], plan["groups"]) == ("key_groups", groups)
        for name, gt, gj, gr in zip("qkv", g, g_j, g_r):
            np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=2e-3,
                                       err_msg=name)
            np.testing.assert_allclose(gt.numpy(), np.asarray(gr), atol=1e-4,
                                       err_msg=name)


def _stream_fwd(lib, q, k, v, H, causal):
    """B7's fp32 forward through its entry: (out, lse)."""
    B, Lq, D = q.shape
    o, lse = torch.empty(B, Lq, D), torch.empty(B, H, Lq)
    P = torch.Tensor.data_ptr
    assert lib.streaming_attention_f32(
        P(q), P(k), P(v), P(o), P(lse), B, Lq, k.shape[1], H, 64,
        *tfa._qkv_strides(q, k, v), o.stride(0), o.stride(1), 64 ** -0.5,
        int(causal), None) == 0
    return o, lse


def test_f32_stream_forward_against_jax(emu):
    """B7's fp32 forward held directly against JAX's at the text tower's
    77 tokens, causal: out against _streaming_flash (the stock Pallas TPU
    kernel in interpret mode), lse against that kernel's own residuals m +
    log l on the same head-major padded rows (what _streaming_flash's
    custom VJP saves), both within tests/test_flash_attention.py's
    tolerance for the causal text shape (atol 1e-4)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from jax.experimental.pallas.ops.tpu import flash_attention as stock
    from gava_clip_tpu.ops import flash_attention as jflash
    B, L, H, Lp = 1, 77, 2, 128
    q, k, v, _ = _inputs(13, B, L, L, H, False)
    o, lse = _stream_fwd(emu[1], q, k, v, H, True)
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))

    def head_major(x):
        x = jnp.pad(x, ((0, 0), (0, Lp - L), (0, 0)))
        return x.reshape(B, Lp, H, 64).transpose(0, 2, 1, 3)
    with pltpu.force_tpu_interpret_mode():
        o_j = jflash._streaming_flash(jq, jk, jv, H, True)
        _, l_j, m_j = stock._flash_attention(
            head_major(jq), head_major(jk), head_major(jv), None, None, True,
            True, 64 ** -0.5, stock.BlockSizes.get_default(B, H, Lp, Lp, 64),
            False)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=1e-4)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(m_j + jnp.log(l_j))[:, :, :L],
                               atol=1e-4)


def test_f32_packed_bwd_global_accumulator_walks_the_items(emu):
    """The packed backward with its dq accumulator in the global scratch
    and fewer blocks than (batch row, head) items, each block walking them
    with a grid stride, gives the bits of the plan's shared form, for B6b
    and B8."""
    _, lib = emu
    B, Lq, Lk, H = 2, 29, 21, 2
    q, k, v, do = _inputs(1, B, Lq, Lk, H, False)
    D, Dh = H * 64, 64
    strides = tfa._qkv_strides(q, k, v)
    P = torch.Tensor.data_ptr
    o, den = tfa.packed_attention_den_plain(q, k, v, H)
    plan = tfa.attention_f32_plan(B, Lq, Lk, H)["bwd"]
    assert plan["acc_in_smem"] and plan["grid"] == B * H
    per_block = plan["lq_pad"] * tfa._F32_LAYOUT[9]
    runs = []
    for grid, in_smem in ((plan["grid"], 1), (3, 0), (1, 0)):
        scratch = torch.full((grid * per_block,), float("nan"))
        smem = plan["smem_bytes"] if in_smem else tfa._F32_LAYOUT[8]
        tail = (B, Lq, Lk, H, Dh, *strides, plan["lq_pad"], grid, in_smem,
                smem, Dh ** -0.5, None)
        g6 = [torch.empty(B, L, D) for L in (Lq, Lk, Lk)]
        g8 = [torch.empty(B, L, D) for L in (Lq, Lk, Lk)]
        assert lib.packed_attention_bwd_f32(
            P(q), P(k), P(v), P(do), P(o), P(den), *map(P, g6), P(scratch),
            *tail) == 0
        o8, den8 = torch.empty(B, Lq, D), torch.empty(B, Lq, H)
        assert lib.packed_attention_bwd_recompute_f32(
            P(q), P(k), P(v), P(do), P(o8), P(den8), *map(P, g8), P(scratch),
            *tail) == 0
        runs.append(g6 + g8)
    want = tfa.packed_attention_bwd_plain(q, k, v, do, o, den, H)
    for a, b in zip(runs[0][:3], want):
        assert ((a - b).abs() / b.abs().max()).max().item() <= F32_REL
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


@pytest.mark.parametrize("shape", [(3, 13, 21, 2), (2, 40, 100, 4)])
def test_f32_packed_forward_as_close_to_float64_as_torch(emu, shape):
    """B1's 3xTF32 forward, with the emulated tensor core truncating what it
    accumulates, lies at least as close to the float64 attention as the
    plain version's fp32 matmuls do (each step's products summed in a fresh
    accumulator and added in fp32: a chain of products into one
    accumulator drifts to ~3x the plain version's distance)."""
    _, lib = emu
    B, Lq, Lk, H = shape
    q, k, v, _ = _inputs(7, B, Lq, Lk, H, False)
    D, P = H * 64, torch.Tensor.data_ptr
    o = torch.empty(B, Lq, D)
    assert lib.packed_attention_f32(
        P(q), P(k), P(v), P(o), B, Lq, Lk, H, 64, *tfa._qkv_strides(q, k, v),
        o.stride(0), o.stride(1), 64 ** -0.5 * tfa._LOG2E, None) == 0
    qh, kh, vh = (tfa._heads(x, H).double() for x in (q, k, v))
    e = torch.exp2(torch.clamp(qh @ kh.transpose(-1, -2)
                               * (64 ** -0.5 * tfa._LOG2E), max=110.0))
    exact = ((e @ vh) / e.sum(-1, keepdim=True)).transpose(1, 2) \
        .reshape(B, Lq, D)
    spread = tfa.packed_attention_plain(q, k, v.abs(), H).double()

    def dist(x):
        return ((x.double() - exact).abs() / spread).max().item()
    assert dist(o) <= dist(tfa.packed_attention_plain(q, k, v, H))


@pytest.mark.parametrize("shape", [(2, 77, 77, 2), (1, 150, 170, 1)])
def test_f32_stream_forward_as_close_to_float64_as_torch(emu, shape):
    """B7's 3xTF32 forward (causal), with the emulated tensor core
    truncating what it accumulates and its sums rescaled as its running max
    moves, lies at least as close to the float64 causal softmax attention
    as the plain version's fp32 does: the root mean square of the error
    over the scale (the largest single error is one rounding either way at
    these sizes: 0.61-1.11x the plain version's over four seeds, the RMS
    0.66-0.81x over eight); its lse within F32_LSE_ABS of the float64
    one."""
    _, lib = emu
    B, Lq, Lk, H = shape
    q, k, v, _ = _inputs(8, B, Lq, Lk, H, False)
    o, lse = _stream_fwd(lib, q, k, v, H, True)
    qh, kh, vh = (tfa._heads(x, H).double() for x in (q, k, v))
    s = (qh @ kh.transpose(-1, -2)) * 64 ** -0.5
    s = s.masked_fill(~torch.ones(Lq, Lk, dtype=torch.bool).tril(),
                      float("-inf"))
    exact = (torch.softmax(s, -1) @ vh).transpose(1, 2).reshape(B, Lq, H * 64)
    spread = tfa.streaming_attention_plain(q, k, v.abs(), H, True)[0].double()

    def dist(x):
        return (((x.double() - exact) / spread) ** 2).mean().sqrt().item()
    assert dist(o) <= dist(tfa.streaming_attention_plain(q, k, v, H, True)[0])
    assert (lse.double() - torch.logsumexp(s, -1)).abs().max().item() <= 3e-5


# one warp's 16 x 8 x 8 product through csrc/tf32_frags.cuh: mode 0 one
# TF32 product of the operands as they are, mode 1 the 3xTF32 product of
# their split parts
_MMA_SRC = r"""
#include "cuda_runtime.h"
#include "tf32_frags.cuh"

struct MArgs {
  const float *A, *B;   // A 16 x 8, B 8 x 8 (k x n), row-major
  float* C;             // 16 x 8
  int mode;
};

__global__ void mma_kernel(const MArgs& a) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const float x[4] = {a.A[g * 8 + t], a.A[(g + 8) * 8 + t], a.A[g * 8 + t + 4],
                      a.A[(g + 8) * 8 + t + 4]};
  const float y[2] = {a.B[t * 8 + g], a.B[(t + 4) * 8 + g]};
  uint32_t ah[4], al[4], bh[2], bl[2];
  for (int i = 0; i < 4; ++i) tf32::split(x[i], ah[i], al[i]);
  for (int i = 0; i < 2; ++i) tf32::split(y[i], bh[i], bl[i]);
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  if (a.mode == 0) {
    const uint32_t ar[4] = {__float_as_uint(x[0]), __float_as_uint(x[1]),
                            __float_as_uint(x[2]), __float_as_uint(x[3])};
    tf32::mma_tf32(d, ar, __float_as_uint(y[0]), __float_as_uint(y[1]));
  } else {
    tf32::mma_tf32(d, al, bh[0], bh[1]);
    tf32::mma_tf32(d, ah, bl[0], bl[1]);
    tf32::mma_tf32(d, ah, bh[0], bh[1]);
  }
  a.C[g * 8 + 2 * t] = d[0];
  a.C[g * 8 + 2 * t + 1] = d[1];
  a.C[(g + 8) * 8 + 2 * t] = d[2];
  a.C[(g + 8) * 8 + 2 * t + 1] = d[3];
}

extern "C" int run_mma(const float* A, const float* B, float* C, int mode) {
  const MArgs a{A, B, C, mode};
  emu_launch(mma_kernel, dim3(1), 32, 0, a);
  return 0;
}
"""


def test_emulated_tf32_mma_against_numpy(emu):
    """The emulation's mma.sync m16n8k8 TF32 and csrc/tf32_frags.cuh's split
    against numpy: integer operands (TF32 values, as B11's codes) give the
    exact product, so the fragment layout is the PTX one; random fp32
    operands give the float64 product within 2^-20 of sum |a||b| as 3xTF32,
    and miss it by more than 2^-14 as one TF32 product of the operands as
    they are (the tensor core reads their top 19 bits)."""
    tmp, _ = emu
    (tmp / "mma.cpp").write_text(_MMA_SRC)
    so = tmp / "libmma.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(tmp), "-o", str(so),
                    str(tmp / "mma.cpp")], check=True, capture_output=True,
                   timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.run_mma.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    rs = np.random.RandomState(5)

    def run(A, B, mode):
        A, B = np.ascontiguousarray(A, np.float32), \
            np.ascontiguousarray(B, np.float32)
        C = np.empty((16, 8), np.float32)
        assert lib.run_mma(A.ctypes.data, B.ctypes.data, C.ctypes.data,
                           mode) == 0
        return C

    A, B = rs.randint(-127, 128, (16, 8)), rs.randint(-127, 128, (8, 8))
    assert np.array_equal(run(A, B, 0), (A @ B).astype(np.float32))
    assert np.array_equal(run(A, B, 1), (A @ B).astype(np.float32))
    A, B = rs.randn(16, 8), rs.randn(8, 8)
    A32, B32 = A.astype(np.float32), B.astype(np.float32)
    ref = A32.astype(np.float64) @ B32.astype(np.float64)
    scale = np.abs(A32).astype(np.float64) @ np.abs(B32).astype(np.float64)
    assert (np.abs(run(A, B, 1) - ref) / scale).max() <= 2.0 ** -20
    assert (np.abs(run(A, B, 0) - ref) / scale).max() > 2.0 ** -14


@pytest.mark.parametrize("name", [n for n in kernel_mutants.MUTANTS
                                  if n.startswith("f32_")])
def test_f32_mutants_fail_the_limit(emu, name):
    """Each fp32 mutant, built from the source with the mutant's own edits,
    breaks the limit of the kernel it targets at one of the shapes (the
    shapes taken in order up to the first that does)."""
    tmp, _ = emu
    path, edits, _, word = kernel_mutants.MUTANTS[name]
    assert path.endswith(_SOURCE.name)
    src = _SOURCE.read_text()
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    lib = _build(tmp, name, src)
    target = word.split()[0]
    errs = []
    for shape in _SHAPES:
        *dims, causal, sliced = shape
        if (causal is None) != target.startswith("packed"):
            continue
        # B7's backward past 128 rows (f32_b7b_*): its own form's shapes
        if name.startswith("f32_b7b_") and max(dims[1:3]) <= 128:
            continue
        errs.append(_run(lib, *dims, causal=causal, sliced=sliced)[target])
        if errs[-1] > F32_REL:   # rejected: the other shapes add nothing
            break
    assert max(errs) > F32_REL, (name, errs)


def test_attention_wrappers_take_bf16_or_fp32_and_refuse_the_rest():
    """The dtype rules hold before any device work: all bfloat16 or all
    float32 (then a CPU tensor is refused for want of a card), mixed or
    half inputs raise TypeError. The w8a8 attention + out-projection takes
    fp32 in every form: B4, its int8 QK^T form (B11) and its two-source
    entry (B12) with either score."""
    x = torch.zeros(1, 5, 128)
    op = {"kernel": {"qa": torch.zeros(128, 128, dtype=torch.int8),
                     "scale": torch.ones(1, 128)}, "bias": torch.zeros(128)}
    for dtype in (torch.float32, torch.bfloat16):
        t = x.to(dtype)
        with pytest.raises(ValueError, match="CUDA"):
            tfa.packed_attention_cuda(t, t, t, 2)
        for int8_qk in (False, True):
            with pytest.raises(ValueError, match="CUDA"):
                tfa.attention_out_int8_cuda(t, t, t, 2, op, t,
                                            int8_qk=int8_qk)
            with pytest.raises(ValueError, match="CUDA"):
                tfa.attention_out_int8_2src_cuda(t, t, t, t, t, 2, op, t,
                                                 int8_qk=int8_qk)
    with pytest.raises(TypeError, match="all bfloat16 or all float32"):
        tfa.packed_attention_den_cuda(x, x.bfloat16(), x, 2)
    with pytest.raises(TypeError, match="all bfloat16 or all float32"):
        tfa.streaming_attention_cuda(x.half(), x.half(), x.half(), 2, True)
    with pytest.raises(TypeError, match="all bfloat16 or all float32"):
        tfa.attention_out_int8_cuda(x.half(), x.half(), x.half(), 2, op,
                                    x.half(), int8_qk=True)
    with pytest.raises(TypeError, match="all bfloat16 or all float32"):
        tfa.attention_out_int8_2src_cuda(x, x.bfloat16(), x, x, x, 2, op, x)
    assert set(tfa.launch_counts.values()) == {0}


# ---------------------------------------------------------------------------
# the int8-score form (B11) and the two-source form (B12)
# ---------------------------------------------------------------------------

def _a12_inputs(seed, B, Lq, Lk, H, ties):
    """q, k, v (B, L, H*64) fp32; `ties`: q and k rows from
    chip_smoke.int8_qk_tie_rows (values on their codes' rounding ties)."""
    rs = np.random.RandomState(seed)
    D = H * 64
    if ties:
        q = chip_smoke.int8_qk_tie_rows(rs, B * Lq * H).reshape(B, Lq, D)
        k = chip_smoke.int8_qk_tie_rows(rs, B * Lk * H).reshape(B, Lk, D)
    else:
        q, k = rs.randn(B, Lq, D), rs.randn(B, Lk, D)
    v = rs.randn(B, Lk, D)
    return tuple(torch.from_numpy(np.asarray(a, np.float32))
                 for a in (q, k, v))


def _run_a12(lib, B, Lq, Lk, H, ties, seed=0, seq=None):
    """The int8-score and two-source entries at one shape: {'args': the
    int8 form's exp2 arguments equal the plain version's bit for bit,
    'packed_attention_qk8_f32' / 'packed_attention_2src_f32': max err /
    scale of B11 and of B12 in its int8 form against the plain int8
    version, 'two': both two-source forms equal the one-source forms on
    the concatenated keys bit for bit, and with `seq` (the library of
    _SEQ_SRC) 'seq': both one-source forms equal the sequential reference
    bit for bit}. The second source is a column view of one (B, L2, 2D)
    projection (row stride 2D) and starts inside a key tile."""
    q, k, v = _a12_inputs(seed, B, Lq, Lk, H, ties)
    D, Dh = H * 64, 64
    c = Dh ** -0.5 * tfa._LOG2E
    cq = c / (127.0 * 127.0)
    P = torch.Tensor.data_ptr
    res = {}
    args = torch.empty(B, H, Lq, Lk)
    assert lib.attention_f32_qk8_args(
        P(q), P(k), P(args), B, Lq, Lk, H, Dh, q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), cq, None) == 0
    want = tfa._int8_qk_exp2_arg(tfa._heads(q, H), tfa._heads(k, H), c)
    res["args"] = torch.equal(args, want)
    ref = tfa._onepass_attention_den_f32(q, k, v, H, int8_qk=True)[0]
    spread = tfa._onepass_attention_den_f32(q, k, v.abs(), H,
                                            int8_qk=True)[0]
    L1 = Lk // 3 + 1
    k1, v1 = k[:, :L1].contiguous(), v[:, :L1].contiguous()
    kv2 = torch.cat([k[:, L1:], v[:, L1:]], dim=-1)
    k2, v2 = kv2[..., :D], kv2[..., D:]
    res["two"] = True
    res["seq"] = seq is not None
    for int8_qk in (0, 1):
        one, two = torch.empty(B, Lq, D), torch.empty(B, Lq, D)
        entry = lib.packed_attention_qk8_f32 if int8_qk \
            else lib.packed_attention_fma_f32
        strides = (*tfa._qkv_strides(q, k, v), one.stride(0), one.stride(1))
        assert entry(P(q), P(k), P(v), P(one), B, Lq, Lk, H, Dh, *strides,
                     cq if int8_qk else c, None) == 0
        assert lib.packed_attention_2src_f32(
            P(q), P(k1), P(v1), P(k2), P(v2), P(two), B, Lq, L1, Lk - L1, H,
            Dh, q.stride(0), q.stride(1), k1.stride(0), k1.stride(1),
            v1.stride(0), v1.stride(1), k2.stride(0), k2.stride(1),
            v2.stride(0), v2.stride(1), two.stride(0), two.stride(1),
            cq if int8_qk else c, int8_qk, None) == 0
        res["two"] = res["two"] and torch.equal(one, two)
        if seq is not None:
            want_seq = torch.full_like(one, float("nan"))
            seq.seq_attention(P(q), P(k), P(v), P(want_seq), B, Lq, Lk, H,
                              *strides, cq if int8_qk else c, int8_qk)
            res["seq"] = res["seq"] and torch.equal(one, want_seq)
        if int8_qk:
            res["packed_attention_qk8_f32"] = (
                (one - ref).abs() / spread).max().item()
            res["packed_attention_2src_f32"] = (
                (two - ref).abs() / spread).max().item()
    return res


# The order that B4's and B11's limits on the card depend on, written out
# one operation after another: per (batch row, head, query row) each score
# as fmaf over the head columns in order from 0 (the int8 form: the codes'
# exact integer product, then (s32 * (qs * cq)) * ks), e = exp2f(min(s c,
# 110)) (exp2f for the card's ex2.approx, as in the emulation), den the sum
# over the key tiles of 64 in order of each tile's e (0 past Lk) as a
# pairwise tree (four keys, then eight sums of four in pairs, in each half
# of 32, then the halves), each numerator fmaf over the keys in order from
# 0, out = num / max(den, 1e-30). The codes: qs = max(absmax, 1e-6), rint(x
# * (127 / qs)).
_SEQ_SRC = r"""
#include <cmath>
#include <cstdint>
#include <vector>

static float codes(const float* x, int8_t* out) {
  float m = 0.f;
  for (int d = 0; d < 64; ++d) m = std::fmax(m, std::fabs(x[d]));
  const float qs = std::fmax(m, 1e-6f);
  const float inv = 127.f / qs;
  for (int d = 0; d < 64; ++d) out[d] = static_cast<int8_t>(std::rint(x[d] * inv));
  return qs;
}

extern "C" void seq_attention(const float* q, const float* k, const float* v, float* o,
                              int B, int Lq, int Lk, int H, int q_sb, int q_sl, int k_sb,
                              int k_sl, int v_sb, int v_sl, int o_sb, int o_sl, float c,
                              int int8_qk) {
  std::vector<float> e(Lk), ks(Lk);
  std::vector<int8_t> kc(64 * Lk), qc(64);
  for (int b = 0; b < B; ++b)
    for (int h = 0; h < H; ++h) {
      const float* kb = k + static_cast<long long>(b) * k_sb + 64 * h;
      const float* vb = v + static_cast<long long>(b) * v_sb + 64 * h;
      if (int8_qk)
        for (int j = 0; j < Lk; ++j) ks[j] = codes(kb + static_cast<long long>(j) * k_sl, &kc[64 * j]);
      for (int i = 0; i < Lq; ++i) {
        const float* qr = q + static_cast<long long>(b) * q_sb + static_cast<long long>(i) * q_sl + 64 * h;
        const float qf = int8_qk ? codes(qr, qc.data()) * c : 0.f;
        for (int j = 0; j < Lk; ++j) {
          const float* kr = kb + static_cast<long long>(j) * k_sl;
          float arg;
          if (int8_qk) {
            int s32 = 0;
            for (int d = 0; d < 64; ++d) s32 += qc[d] * kc[64 * j + d];
            arg = (static_cast<float>(s32) * qf) * ks[j];
          } else {
            float s = 0.f;
            for (int d = 0; d < 64; ++d) s = std::fmaf(qr[d], kr[d], s);
            arg = s * c;
          }
          e[j] = std::exp2f(std::fmin(arg, 110.f));
        }
        float den = 0.f;
        for (int k0 = 0; k0 < Lk; k0 += 64) {
          float t[2];
          for (int h = 0; h < 2; ++h) {
            float p[8];
            for (int m = 0; m < 8; ++m) {
              float x[4];
              for (int u = 0; u < 4; ++u) {
                const int j = k0 + 32 * h + 4 * m + u;
                x[u] = j < Lk ? e[j] : 0.f;
              }
              p[m] = (x[0] + x[1]) + (x[2] + x[3]);
            }
            t[h] = ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]));
          }
          den += t[0] + t[1];
        }
        float* orow = o + static_cast<long long>(b) * o_sb + static_cast<long long>(i) * o_sl + 64 * h;
        for (int d = 0; d < 64; ++d) {
          float num = 0.f;
          for (int j = 0; j < Lk; ++j)
            num = std::fmaf(e[j], vb[static_cast<long long>(j) * v_sl + d], num);
          orow[d] = num / std::fmax(den, 1e-30f);
        }
      }
    }
}
"""


@pytest.fixture(scope="module")
def seq(emu):
    """The sequential reference (_SEQ_SRC) as a shared library."""
    tmp, _ = emu
    (tmp / "seq.cpp").write_text(_SEQ_SRC)
    so = tmp / "libseq.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-o",
                    str(so), str(tmp / "seq.cpp")], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.seq_attention.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 \
        + [ctypes.c_float, ctypes.c_int]
    lib.seq_attention.restype = None
    return lib


# (B, Lq, Lk, H, tie rows): ragged tiles, more key than query tiles with
# the second source starting inside the first key tile, Lk at a tile's edge
_A12_SHAPES = [(2, 13, 21, 2, False), (1, 70, 130, 1, True),
               (1, 65, 64, 2, True)]


@pytest.mark.parametrize("shape", _A12_SHAPES)
def test_int8_qk_and_two_source_forms_match_plain_versions(emu, seq, shape):
    """B11's exp2 arguments through the kernel's own steps equal the plain
    version's bit for bit; B4's and B11's attention equal the sequential
    reference bit for bit (the order their limits on the card depend on)
    and B11's lies within F32_REL of the plain int8 version; B12 in both
    score forms equals the one-source form on the concatenated keys bit for
    bit."""
    res = _run_a12(emu[1], *shape, seq=seq)
    assert res["args"]
    assert res["seq"]
    assert res["two"]
    for name in ("packed_attention_qk8_f32", "packed_attention_2src_f32"):
        assert res[name] <= F32_REL, (name, res[name])


@pytest.mark.parametrize("name", [n for n in kernel_mutants.MUTANTS
                                  if n.startswith(("f32b11_", "f32b12_"))])
def test_int8_qk_and_two_source_mutants_fail(emu, name):
    """B11's mutants (codes by the reciprocal, the rescale in another
    order) change the exp2 arguments at one of the shapes; B12's (the
    second source read from the first) the two-source output."""
    tmp, _ = emu
    path, edits, _, _ = kernel_mutants.MUTANTS[name]
    assert path.endswith(_SOURCE.name)
    src = _SOURCE.read_text()
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    lib = _build(tmp, name, src)
    check = "args" if name.startswith("f32b11_") else "two"
    assert not all(_run_a12(lib, *shape)[check] for shape in _A12_SHAPES)


def test_fma_forward_tf32_mutant_leaves_the_order(emu, seq):
    """B4's mutant of the card's w8a8-f32 phase (its scores' products taken
    in TF32) no longer equals the sequential reference."""
    tmp, _ = emu
    path, edits, _, _ = kernel_mutants.MUTANTS["f32w8_b4_products_tf32"]
    assert path.endswith(_SOURCE.name)
    src = _SOURCE.read_text()
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    lib = _build(tmp, "f32w8_b4_products_tf32", src)
    assert not _run_a12(lib, *_A12_SHAPES[0], seq=seq)["seq"]


# one warp's 16 x 8 x 32 int8 product through csrc/tf32_frags.cuh's mma_s8
_MMA_S8_SRC = r"""
#include "cuda_runtime.h"
#include "tf32_frags.cuh"

struct SArgs {
  const int8_t *A, *B;   // A 16 x 32, B 32 x 8 (k x n), row-major
  int* C;                // 16 x 8, added to
};

__global__ void mma_s8_kernel(const SArgs& a) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  auto word = [](const int8_t* p, int stride) {
    uint32_t w = 0;
    for (int i = 0; i < 4; ++i) w |= static_cast<uint32_t>(static_cast<uint8_t>(p[i * stride])) << (8 * i);
    return w;
  };
  const uint32_t x[4] = {word(a.A + g * 32 + 4 * t, 1), word(a.A + (g + 8) * 32 + 4 * t, 1),
                         word(a.A + g * 32 + 16 + 4 * t, 1),
                         word(a.A + (g + 8) * 32 + 16 + 4 * t, 1)};
  int d[4] = {a.C[g * 8 + 2 * t], a.C[g * 8 + 2 * t + 1], a.C[(g + 8) * 8 + 2 * t],
              a.C[(g + 8) * 8 + 2 * t + 1]};
  tf32::mma_s8(d, x, word(a.B + 4 * t * 8 + g, 8), word(a.B + (16 + 4 * t) * 8 + g, 8));
  a.C[g * 8 + 2 * t] = d[0];
  a.C[g * 8 + 2 * t + 1] = d[1];
  a.C[(g + 8) * 8 + 2 * t] = d[2];
  a.C[(g + 8) * 8 + 2 * t + 1] = d[3];
}

extern "C" int run_mma_s8(const int8_t* A, const int8_t* B, int* C) {
  const SArgs a{A, B, C};
  emu_launch(mma_s8_kernel, dim3(1), 32, 0, a);
  return 0;
}
"""


def test_emulated_s8_mma_against_numpy(emu):
    """The emulation's mma.sync m16n8k32 s8 (csrc/tf32_frags.cuh's mma_s8,
    B11's score product) against numpy's int32 product, added to an int32
    accumulator, at random codes and at the extremes +-127 and -128: the
    fragment layout is the PTX one and the sum exact."""
    tmp, _ = emu
    (tmp / "mma_s8.cpp").write_text(_MMA_S8_SRC)
    so = tmp / "libmma_s8.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(tmp), "-o", str(so),
                    str(tmp / "mma_s8.cpp")], check=True, capture_output=True,
                   timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.run_mma_s8.argtypes = [ctypes.c_void_p] * 3
    rs = np.random.RandomState(6)
    for A, B in ((rs.randint(-127, 128, (16, 32)),
                  rs.randint(-127, 128, (8, 32)).T),
                 (np.full((16, 32), -128), np.full((32, 8), -128)),
                 (np.full((16, 32), 127), np.full((32, 8), -127))):
        A, B = np.ascontiguousarray(A, np.int8), np.ascontiguousarray(B, np.int8)
        C0 = rs.randint(-2 ** 20, 2 ** 20, (16, 8)).astype(np.int32)
        C = C0.copy()
        assert lib.run_mma_s8(A.ctypes.data, B.ctypes.data, C.ctypes.data) == 0
        want = C0 + A.astype(np.int32) @ B.astype(np.int32)
        assert np.array_equal(C, want)
