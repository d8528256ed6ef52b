"""Attention over packed activations (port of
gava_clip_tpu/ops/flash_attention.py): the packed whole-row kernels,
forward and backward, and the streaming kernels for causal or long keys.

q is (B, Lq, H*Dh), k/v are (B, Lk, H*Dh), packed as the projections emit
them — no head relayout. Two regimes, dispatched by `flash_attention` as
the JAX function does.

Non-causal, Lk <= 640: the packed kernels. The softmax is the JAX kernel's
one-pass form (`_onepass_softmax_av_masked`), which is a different function
from a standard softmax once scores pass the clamp:

  * the scale folds into the exp2 constant: e = exp2(min(s * c, 110)) with
    c = Dh**-0.5 * log2(e) and s the fp32 score;
  * there is no max subtraction — the clamp at exp2-argument 110 is the
    semantics, not an optimisation;
  * e is cast to v's dtype BEFORE both the AV product and the denominator
    (on the TPU the denominator is the ones column of the same dot);
  * out = (e @ v) / max(sum(e), 1e-30), cast to the output dtype.

When a gradient is wanted the forward also emits the per-head
denominators den (B, Lq, H) fp32 (the sums of the rounded e), and the
backward rebuilds e from q and k and consumes the saved output and den
(JAX `_packed_flash_saved`); `packed_attention_bwd_plain` spells out its
rounding points. `set_flash_bwd_mode("recompute")` (or
GAVA_FLASH_BWD=recompute in the environment) selects the other backward
of the JAX package (`_packed_flash_recompute`): the forward writes no
denominators and saves q, k, v only, and the backward rebuilds the output
and the denominators itself (`packed_attention_bwd_recompute_plain`; it
takes delta from the unrounded fp32 output, the one rounding point in which
the two modes differ).

`enable_clamp_monitor` turns on the drift monitor of the one-pass softmax:
every packed call then also computes the exact largest positive exp2
argument outside the kernel and keeps the running maximum on the device;
`read_clamp_stats` fetches it (one sync, at the caller's print step).

Causal, or Lk > 640: the streaming kernels, a KV-blocked online softmax
(standard softmax with max subtraction, probabilities cast to v's dtype
before the AV product) that saves the per-row log-sum-exp for its backward
(JAX `_streaming_flash`). The causal mask is top-left aligned: key j is
visible to query row i iff j <= i.

Every function dispatches on the tensor's device: a CPU tensor runs the
plain version (`*_plain`); a CUDA tensor runs the hand-written kernel in
csrc/ or raises. There is no fallback between the two. The gradients are
`torch.autograd.Function`s whose backward is a kernel too.

Each of these kernels has a bf16 form and a float32 form, picked by the
dtype of q, k, v (all bfloat16 or all float32): the bf16 kernels above, and
csrc/attention_f32.cu, where the packed attention of B1 / B6a, B6b and B8
and B7's forward and backward (its forms in `stream_bwd_f32_launches`)
take their products as 3xTF32 on the tensor cores (fp32 accuracy), and
every cast to v's dtype is a no-op (`attention_f32_plan`; launch counts
`*_f32`). Nothing is
cast from one to the other. The w8a8 serving fusion below takes float32
too, in its every form, in two launches each: the fp32 attention (B1's
function summed in the plain version's order, its int8-score form B11, or
either over two sources, B12) into a scratch, then
B2's fp32 form with the residual (launch counts `attention_out_int8_f32`,
`attention_out_int8_qk8_f32`, `attention_out_int8_2src_f32`, one for the
pair).

`flash_attention_out_int8` is the w8a8 serving fusion (TPU
`_attention_out_kernel` + `_int8_outproj_epilogue`): the same attention
over the first `lq` query rows and all keys (any number of them: its
kernels stream key tiles), kept in fp32, then a per-row
int8 quant over the whole H*Dh-wide row, the int8 out-projection, bias and
the residual add (csrc/attention_out_int8.cu; plain version
`attention_out_int8_plain`); `flash_attention_out_int8_2src` is the same
over the keys [k1; k2] of two arrays that are never concatenated in device
memory (TPU `_attention_out_kernel_2src`). Its int8 QK^T form (`set_int8_qk`, or
GAVA_INT8_QK=1 in the environment; off by default) quantizes each head's
slice of every query and key row to int8 and runs the score product in
int8, with the two row scales folded into the exp2 argument; the other
attention functions never take it.
"""

import contextlib
import os
from typing import Dict, Optional, Tuple

import torch

_LOG2E = 1.4426950408889634
_CLAMP = 110.0
_LN2 = 0.6931471805599453
# above this key length the JAX package switches to the streaming kernel
_PACKED_MAX_LK = 640
_KERNEL_HEAD_DIM = 64     # the only head width the kernel is built for

# launches of each hand-written kernel since the last reset; a run reads
# these to show that its main path went through the kernels
launch_counts = {"packed_attention": 0, "attention_out_int8": 0,
                 "attention_out_int8_qk8": 0, "attention_out_int8_f32": 0,
                 "attention_out_int8_2src": 0,
                 "attention_out_int8_qk8_f32": 0,
                 "attention_out_int8_2src_f32": 0,
                 "packed_attention_den": 0, "packed_attention_bwd": 0,
                 "packed_attention_bwd_recompute": 0,
                 "streaming_attention": 0, "streaming_attention_bwd": 0,
                 # the float32 forms (csrc/attention_f32.cu)
                 "packed_attention_f32": 0, "packed_attention_den_f32": 0,
                 "packed_attention_bwd_f32": 0,
                 "packed_attention_bwd_recompute_f32": 0,
                 "streaming_attention_f32": 0,
                 "streaming_attention_bwd_f32": 0}
# kernel launches of B7's fp32 backward by the form its plan took: one
# launch a call up to 128 rows ('one_launch'); past that 'key_groups', one
# launch a call, or two (the dq reduction) where its plan cuts the keys into
# groups
stream_bwd_f32_launches = {"one_launch": 0, "key_groups": 0}
# the same for B7's bf16 backward: 'one_launch' up to 128 rows, past that
# 'key_groups', two launches a call (the rows' stats, the wgmma kernel) or
# three (the dq sum) where its plan cuts the keys into groups
stream_bwd_launches = {"one_launch": 0, "key_groups": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, stream_bwd_f32_launches,
                   stream_bwd_launches):
        for name in counts:
            counts[name] = 0


_force_plain = False

# int8 QK^T score products in the w8a8 serving fusion
# (`flash_attention_out_int8`), read at every call
_INT8_QK = os.environ.get("GAVA_INT8_QK", "0") == "1"


def set_int8_qk(enabled: bool) -> None:
    """Route the score products of `flash_attention_out_int8` through int8
    (per-row q / k quantization, the rescale folded into the exp2
    argument). Affects calls made after it."""
    global _INT8_QK
    _INT8_QK = bool(enabled)


@contextlib.contextmanager
def plain_versions():
    """Inside this context `flash_attention` (forward and backward) runs
    the plain versions on every device. It exists to hold a whole step
    through the kernels against the same step without them on the card; the
    port's own paths never enter it."""
    global _force_plain
    before, _force_plain = _force_plain, True
    try:
        yield
    finally:
        _force_plain = before


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, L, D = x.shape
    return x.reshape(B, L, num_heads, D // num_heads).transpose(1, 2)


def _unheads(x: torch.Tensor) -> torch.Tensor:
    B, H, L, Dh = x.shape
    return x.transpose(1, 2).reshape(B, L, H * Dh)


def _onepass_attention_f32(q, k, v, num_heads: int) -> torch.Tensor:
    """The one-pass clamp softmax attention, (B, Lq, H*Dh) fp32 output."""
    return _onepass_attention_den_f32(q, k, v, num_heads)[0]


def _int8_qk_exp2_arg(qh, kh, c: float) -> torch.Tensor:
    """The exp2 argument of the int8 QK^T form from fp32 head slices
    (B, H, L, Dh): per row qs = max(absmax, 1e-6), codes rint(x * (127 /
    qs)) (no clip needed), the integer score product (exact in fp32: at
    most 127^2 * Dh), then ((s32 * (qs * (c / 127^2))) * ks), in that order
    of multiplication."""
    qs = torch.clamp(qh.abs().amax(dim=-1, keepdim=True), min=1e-6)
    ks = torch.clamp(kh.abs().amax(dim=-1, keepdim=True), min=1e-6)
    # a true division: `127.0 / qs` would be reciprocal(qs) * 127, which
    # rounds twice
    top = qs.new_full((), 127.0)
    qq = torch.round(qh * (top / qs))
    kq = torch.round(kh * (top / ks))
    s32 = qq @ kq.transpose(-1, -2)
    return s32 * (qs * (c / (127.0 * 127.0))) * ks.transpose(-1, -2)


def _onepass_attention_den_f32(q, k, v, num_heads: int,
                               int8_qk: bool = False):
    """(out (B, Lq, H*Dh) fp32, den (B, Lq, H) fp32): the one-pass clamp
    softmax attention and its per-head denominators."""
    B, Lq, D = q.shape
    Dh = D // num_heads
    c = Dh ** -0.5 * _LOG2E
    qh = _heads(q, num_heads).float()
    kh = _heads(k, num_heads).float()
    vh = _heads(v, num_heads)
    if int8_qk:
        arg = _int8_qk_exp2_arg(qh, kh, c)
    else:
        arg = (qh @ kh.transpose(-1, -2)) * c         # (B, H, Lq, Lk) fp32
    # The packed forward kernel (csrc/packed_attention.cu) takes this exp2
    # with ex2.approx.ftz: a result below 2^-126 is 0 there, a subnormal
    # here (an e 126 powers of two below 1; only a row whose every key is
    # that far down sees the difference)
    e = torch.exp2(torch.clamp(arg, max=_CLAMP)).to(v.dtype).float()
    num = e @ vh.float()
    den = e.sum(dim=-1, keepdim=True)
    out = num / torch.clamp(den, min=1e-30)
    return (out.transpose(1, 2).reshape(B, Lq, D),
            den[..., 0].transpose(1, 2).contiguous())


def packed_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the packed attention kernel (same math as
    `_onepass_softmax_av_masked` in the JAX package)."""
    return _onepass_attention_f32(q, k, v, num_heads).to(q.dtype)


def _reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int, causal: bool = False) -> torch.Tensor:
    """Standard-softmax oracle: equal to the one-pass form while every scaled
    score stays below the clamp."""
    B, Lq, D = q.shape
    Dh = D // num_heads
    qh = _heads(q, num_heads) * (Dh ** -0.5)
    kh, vh = _heads(k, num_heads), _heads(v, num_heads)
    scores = qh.float() @ kh.float().transpose(-1, -2)
    if causal:
        mask = torch.ones(Lq, k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = probs.to(v.dtype) @ vh
    return out.transpose(1, 2).reshape(B, Lq, D)


def _check_kernel_args(q, k, v, num_heads):
    """Raise unless q, k, v suit the attention kernels: one CUDA device, all
    bfloat16 or all float32, (B, L, H*64) with 16-byte rows."""
    if not q.dtype == k.dtype == v.dtype or \
            q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("the attention kernels take q/k/v all bfloat16 or "
                        f"all float32, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("packed attention kernel needs q, k, v on one "
                         "CUDA device")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q/k/v must be (B, L, H*Dh)")
    B, _, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D % num_heads:
        raise ValueError(f"width {D} not divisible by {num_heads} heads")
    if D // num_heads != _KERNEL_HEAD_DIM:
        raise ValueError(f"head dim {D // num_heads}: the kernel is built "
                         f"for {_KERNEL_HEAD_DIM}")
    esize = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} last dim must be contiguous")
        # the kernels move 16-byte vectors (8 bf16 or 4 fp32 values)
        if t.data_ptr() % 16 or t.stride(0) * esize % 16 or \
                t.stride(1) * esize % 16:
            raise ValueError(f"{name} rows must be 16-byte aligned")


def packed_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """Launch csrc/packed_attention.cu (bf16) or the float32 form in
    csrc/attention_f32.cu on the current stream (no sync)."""
    from ._cuda import load_library
    _check_kernel_args(q, k, v, num_heads)
    if q.dtype == torch.float32:
        return _packed_fwd_f32("packed_attention_f32", q, k, v, num_heads)
    B, Lq, D = q.shape
    Lk = k.shape[1]
    Dh = D // num_heads
    lib = load_library("packed_attention")
    out = torch.empty((B, Lq, D), dtype=q.dtype, device=q.device)
    if B == 0 or Lq == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.packed_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Lq, Lk, num_heads, Dh,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            Dh ** -0.5 * _LOG2E, stream)
    if err != 0:
        raise _launch_failed("packed_attention", lib, err)
    launch_counts["packed_attention"] += 1
    return out


def packed_attention_den_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, num_heads: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the denominator-emitting forward (JAX
    `_attention_kernel_den`): (out in q's dtype, den (B, Lq, H) fp32). den
    is the sum of the e values AFTER their cast to v's dtype."""
    out, den = _onepass_attention_den_f32(q, k, v, num_heads)
    return out.to(q.dtype), den


def packed_attention_bwd_plain(q, k, v, do, o, den, num_heads: int):
    """Plain version of the saved-residual backward (JAX
    `_attention_bwd_kernel`), the explicit formula with its rounding
    points, not autograd: e, ds and do * inv_d are cast to v's dtype before
    their products, the products accumulate in fp32, the scale comes after
    the dot and each gradient is cast once. Returns dq, dk, dv."""
    Dh = q.shape[-1] // num_heads
    scale = Dh ** -0.5
    c = scale * _LOG2E
    qh, kh, vh = (_heads(x, num_heads).float() for x in (q, k, v))
    doh, oh = _heads(do, num_heads).float(), _heads(o, num_heads).float()
    inv_d = (1.0 / torch.clamp(den.float(), min=1e-30)
             ).transpose(1, 2)[..., None]                 # (B, H, Lq, 1)
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    s = qh @ kh.transpose(-1, -2)
    e = torch.exp2(torch.clamp(s * c, max=_CLAMP)).to(v.dtype).float()
    dp = doh @ vh.transpose(-1, -2)
    ds = ((e * inv_d) * (dp - delta)).to(v.dtype).float()
    do_n = (doh * inv_d).to(v.dtype).float()
    dq = (ds @ kh) * scale
    dk = (ds.transpose(-1, -2) @ qh) * scale
    dv = e.transpose(-1, -2) @ do_n
    return (_unheads(dq).to(q.dtype), _unheads(dk).to(k.dtype),
            _unheads(dv).to(v.dtype))


def packed_attention_bwd_recompute_plain(q, k, v, do, num_heads: int):
    """Plain version of the backward that saves no forward output (JAX
    `_attention_bwd_kernel_recompute`): from q, k, v, do alone. It rebuilds
    e, takes den as the fp32 sum of the e values AFTER their cast to v's
    dtype, o = (e @ v) * inv_d in fp32 WITHOUT a cast, delta = rowsum(do *
    o), and then follows `packed_attention_bwd_plain`. Returns dq, dk,
    dv."""
    Dh = q.shape[-1] // num_heads
    scale = Dh ** -0.5
    c = scale * _LOG2E
    qh, kh, vh, doh = (_heads(x, num_heads).float() for x in (q, k, v, do))
    s = qh @ kh.transpose(-1, -2)
    e = torch.exp2(torch.clamp(s * c, max=_CLAMP)).to(v.dtype).float()
    inv_d = 1.0 / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    oh = (e @ vh) * inv_d
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    dp = doh @ vh.transpose(-1, -2)
    ds = ((e * inv_d) * (dp - delta)).to(v.dtype).float()
    do_n = (doh * inv_d).to(v.dtype).float()
    dq = (ds @ kh) * scale
    dk = (ds.transpose(-1, -2) @ qh) * scale
    dv = e.transpose(-1, -2) @ do_n
    return (_unheads(dq).to(q.dtype), _unheads(dk).to(k.dtype),
            _unheads(dv).to(v.dtype))


def _visible(Lq: int, Lk: int, causal: bool, device) -> Optional[torch.Tensor]:
    """(Lq, Lk) bool mask of the keys each query row sees, None when all."""
    if not causal:
        return None
    return torch.ones(Lq, Lk, dtype=torch.bool, device=device).tril()


def streaming_attention_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, num_heads: int,
                              causal: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the streaming forward: standard softmax with max
    subtraction over fp32 scores, the probabilities cast to v's dtype
    before the AV product and summed in fp32. Returns (out in q's dtype,
    lse (B, H, Lq) fp32, the natural-log sum of exp of the scaled scores)."""
    Dh = q.shape[-1] // num_heads
    c = Dh ** -0.5 * _LOG2E
    qh, kh, vh = (_heads(x, num_heads).float() for x in (q, k, v))
    s2 = (qh @ kh.transpose(-1, -2)) * c                   # log2 units
    mask = _visible(q.shape[1], k.shape[1], causal, q.device)
    if mask is not None:
        s2 = s2.masked_fill(~mask, float("-inf"))
    m = s2.max(dim=-1, keepdim=True).values
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    out = (p.to(v.dtype).float() @ vh) / l
    lse = ((m + torch.log2(l)) * _LN2)[..., 0]
    return _unheads(out).to(q.dtype), lse


def streaming_attention_bwd_plain(q, k, v, do, o, lse, num_heads: int,
                                  causal: bool = False):
    """Plain version of the streaming backward, the explicit formula: p is
    rebuilt from the saved log-sum-exp, ds = p * (do v^T - delta) * scale
    and p are cast to v's dtype before their products. Returns dq, dk,
    dv."""
    Dh = q.shape[-1] // num_heads
    scale = Dh ** -0.5
    c = scale * _LOG2E
    qh, kh, vh = (_heads(x, num_heads).float() for x in (q, k, v))
    doh, oh = _heads(do, num_heads).float(), _heads(o, num_heads).float()
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    s2 = (qh @ kh.transpose(-1, -2)) * c
    p = torch.exp2(s2 - (lse.float() * _LOG2E)[..., None])
    mask = _visible(q.shape[1], k.shape[1], causal, q.device)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    dp = doh @ vh.transpose(-1, -2)
    ds = (p * (dp - delta) * scale).to(v.dtype).float()
    dq = ds @ kh
    dk = ds.transpose(-1, -2) @ qh
    dv = p.to(v.dtype).float().transpose(-1, -2) @ doh
    return (_unheads(dq).to(q.dtype), _unheads(dk).to(k.dtype),
            _unheads(dv).to(v.dtype))


def _launch_failed(name: str, lib, err: int) -> RuntimeError:
    return RuntimeError(f"{name} kernel launch failed: "
                        f"{lib.cuda_error_string(err).decode()} ({err})")


def _qkv_strides(q, k, v):
    return (q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1))


def packed_attention_den_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, num_heads: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the denominator-emitting entry of csrc/packed_attention.cu on
    the current stream (no sync), or its float32 form in
    csrc/attention_f32.cu: (out, den (B, Lq, H) fp32)."""
    from ._cuda import load_library
    _check_kernel_args(q, k, v, num_heads)
    if q.dtype == torch.float32:
        return _packed_fwd_f32("packed_attention_den_f32", q, k, v, num_heads)
    B, Lq, D = q.shape
    Dh = D // num_heads
    lib = load_library("packed_attention")
    out = torch.empty((B, Lq, D), dtype=q.dtype, device=q.device)
    den = torch.empty((B, Lq, num_heads), dtype=torch.float32,
                      device=q.device)
    if B == 0 or Lq == 0:
        return out, den
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.packed_attention_den_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            den.data_ptr(), B, Lq, k.shape[1], num_heads, Dh,
            *_qkv_strides(q, k, v), out.stride(0), out.stride(1),
            Dh ** -0.5 * _LOG2E, stream)
    if err != 0:
        raise _launch_failed("packed_attention_den", lib, err)
    launch_counts["packed_attention_den"] += 1
    return out, den


def _check_bwd_args(q, do, o, stat, stat_shape):
    for name, t in (("do", do), ("o", o)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected q's {q.dtype} "
                             f"{tuple(q.shape)} on {q.device}")
    if tuple(stat.shape) != stat_shape or stat.dtype != torch.float32 or \
            stat.device != q.device:
        raise ValueError(f"saved row statistics {stat.dtype} "
                         f"{tuple(stat.shape)}, expected float32 "
                         f"{stat_shape}")


# Launch plan of csrc/packed_attention_bwd.cuh: one block of 8 warps per
# (batch row, head) holds that head's fp32 dq accumulator and row
# statistics, 74 floats per query row (Lq rounded up to 16), beside 153.5 KB
# of tile stages in shared memory; past a block's 227 KB (Lq > 240) they
# move to a block-private region of a global scratch buffer, and a grid of
# one block per SM walks the (row, head) pairs. The three numbers are the
# header's layout: the launch holds them against the library's
# `packed_attention_bwd_layout` before its first use.
_BWD_FIXED_SMEM = 157184          # k / v, q / do, o, den stages, do * inv_d, ds^T
_BWD_ACC_FLOATS_PER_ROW = 74      # 72 (a padded row of dq) + inv_d + delta
_BWD_MAX_SMEM = 232448            # dynamic shared memory one block may use
_bwd_layout_checked = set()


def packed_bwd_plan(B: int, Lq: int, H: int, sm_count: int) -> Dict:
    """Grid, shared-memory bytes and scratch of one launch of the packed
    backward on a card of `sm_count` SMs: {'lq_pad', 'grid', 'acc_in_smem',
    'smem_bytes', 'scratch_floats'}. The grid is one-dimensional; the keys
    (at most 640) stream through fixed tiles, so the plan does not depend
    on them."""
    lq_pad = -(-Lq // 16) * 16
    acc = lq_pad * _BWD_ACC_FLOATS_PER_ROW
    items = B * H
    if _BWD_FIXED_SMEM + 4 * acc <= _BWD_MAX_SMEM:
        return {"lq_pad": lq_pad, "grid": items, "acc_in_smem": True,
                "smem_bytes": _BWD_FIXED_SMEM + 4 * acc, "scratch_floats": 0}
    grid = min(items, sm_count)
    return {"lq_pad": lq_pad, "grid": grid, "acc_in_smem": False,
            "smem_bytes": _BWD_FIXED_SMEM, "scratch_floats": grid * acc}


def _check_layout(name: str, lib, fn: str, want: Tuple[int, ...]) -> None:
    """Raise unless the built library's layout (`fn`'s ints) is the one the
    launch plan computes with."""
    if name in _bwd_layout_checked:
        return
    import ctypes
    out = (ctypes.c_int * len(want))()
    getattr(lib, fn)(out)
    if tuple(out) != tuple(want):
        raise RuntimeError(f"{name}: the kernel's shared-memory layout "
                           f"{tuple(out)} is not the launch plan's {want}")
    _bwd_layout_checked.add(name)


def _packed_bwd_launch(name: str, q, k, v, do, extra, num_heads: int):
    """Allocate the gradients (and the plan's scratch) and launch one entry
    of the packed backward; `extra` are the entry's pointers between do and
    dq (o and den for the saved-residual form, none for recompute)."""
    from ._cuda import load_library
    B, Lq, D = q.shape
    Lk = k.shape[1]
    lib = load_library(name)
    dq = torch.empty((B, Lq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Lk, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Lk, D), dtype=q.dtype, device=q.device)
    if B == 0 or Lq == 0 or Lk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    _check_layout(name, lib, "packed_attention_bwd_layout",
                  (_BWD_FIXED_SMEM, _BWD_ACC_FLOATS_PER_ROW, _BWD_MAX_SMEM))
    plan = packed_bwd_plan(B, Lq, num_heads, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    scratch = None if plan["acc_in_smem"] else torch.empty(
        plan["scratch_floats"], dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = getattr(lib, name + "_bf16")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            *(t.data_ptr() for t in extra), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if scratch is None else scratch.data_ptr(),
            B, Lq, Lk, num_heads, D // num_heads, *_qkv_strides(q, k, v),
            plan["lq_pad"], plan["grid"], int(plan["acc_in_smem"]),
            plan["smem_bytes"], (D // num_heads) ** -0.5, stream)
    if err != 0:
        raise _launch_failed(name, lib, err)
    launch_counts[name] += 1
    return dq, dk, dv


def packed_attention_bwd_cuda(q, k, v, do, o, den, num_heads: int):
    """Launch csrc/packed_attention_bwd.cu (one kernel) or its float32 form
    in csrc/attention_f32.cu on the current stream (no sync). Returns dq,
    dk, dv."""
    _check_kernel_args(q, k, v, num_heads)
    B, Lq, D = q.shape
    _check_bwd_args(q, do, o, den, (B, Lq, num_heads))
    if q.dtype == torch.float32:
        return _bwd_f32("packed_attention_bwd_f32", q, k, v, do,
                        (o.contiguous(), den.contiguous()), num_heads)
    return _packed_bwd_launch("packed_attention_bwd", q, k, v,
                              do.contiguous(),
                              (o.contiguous(), den.contiguous()), num_heads)


def packed_attention_bwd_recompute_cuda(q, k, v, do, num_heads: int):
    """Launch csrc/packed_attention_bwd_recompute.cu (one kernel that
    rebuilds den and delta itself), or its float32 form in
    csrc/attention_f32.cu (the forward into scratch, then B6b's kernel), on
    the current stream (no sync). Returns dq, dk, dv."""
    _check_kernel_args(q, k, v, num_heads)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"do {do.dtype} {tuple(do.shape)} on {do.device}, "
                         f"expected q's {q.dtype} {tuple(q.shape)} on "
                         f"{q.device}")
    if q.dtype == torch.float32:
        B, Lq, D = q.shape
        return _bwd_f32("packed_attention_bwd_recompute_f32", q, k, v, do,
                        (q.new_empty((B, Lq, D)),
                         q.new_empty((B, Lq, num_heads))), num_heads)
    return _packed_bwd_launch("packed_attention_bwd_recompute", q, k, v,
                              do.contiguous(), (), num_heads)


def streaming_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, num_heads: int,
                             causal: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/streaming_attention.cu (bf16) or the float32 form in
    csrc/attention_f32.cu on the current stream (no sync): (out, lse (B, H,
    Lq) fp32)."""
    # the text tower's attention is launch-bound: this wrapper's host time
    # is most of the call's, so it asks for the device, the stream and the
    # current device once each
    from ._cuda import load_library
    _check_kernel_args(q, k, v, num_heads)
    B, Lq, D = q.shape
    if k.shape[1] == 0:
        raise ValueError("streaming attention needs at least one key")
    if q.dtype == torch.float32:
        return _streaming_fwd_f32(q, k, v, num_heads, causal)
    lib = load_library("streaming_attention")
    dev = q.device
    out = torch.empty((B, Lq, D), dtype=q.dtype, device=dev)
    lse = torch.empty((B, num_heads, Lq), dtype=torch.float32, device=dev)
    if B == 0 or Lq == 0:
        return out, lse
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        err = lib.streaming_attention_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Lq, k.shape[1], num_heads, D // num_heads,
            *_qkv_strides(q, k, v), (D // num_heads) ** -0.5, int(causal),
            stream)
    if err != 0:
        raise _launch_failed("streaming_attention", lib, err)
    launch_counts["streaming_attention"] += 1
    return out, lse


# Launch plan of csrc/streaming_attention_bwd.cu: one launch of a block per
# (batch row, head) while every query row and key of a head fits its shared
# tiles ('one_launch'), else the key groups ('key_groups', wgmma). The nine
# numbers are the source's layout (`streaming_attention_bwd_layout`): the
# most query rows and keys of the one-launch form, its dynamic shared bytes
# (q, do, k, v tiles of 128 x 72 bf16, ds^T of 128 x 136 bf16, two floats a
# row) and its threads a block; the key groups' keys a key tile, query rows
# a step, threads a block, fixed shared bytes (the key tile, ds^T, two
# stages of q / do rows and their stats, the alignment's slack), bytes a
# row of the fp32 dq accumulator, and the most shared bytes of a block.
_SBWD_LAYOUT = (128, 109568, 256, 128, 64, 256, 67584, 256, 232448)


def streaming_bwd_plan(B: int, Lq: int, Lk: int, H: int, sm_count: int = 132,
                       groups: Optional[int] = None,
                       causal: bool = False) -> Dict:
    """The form of one call of the bf16 streaming backward on a card of
    `sm_count` SMs: {'form', 'launches', 'groups', 'grid', 'smem_bytes',
    'scratch_floats'}. 'one_launch' (1 launch, grid B * H, no scratch) while
    Lq and Lk fit the one-launch tiles, else 'key_groups': a block per
    (batch row, head, group of key tiles), one an SM, `groups` (default
    `stream_bwd_groups`, as B7's fp32 backward) cutting each pair's key
    tiles, with 'lq_pad' (Lq rounded up to a step), 'tiles' (key tiles a
    group) and 'acc_in_smem' (the block's fp32 dq accumulator in shared
    memory, else in its region of the scratch). Its launches: the rows'
    stats, the wgmma kernel, and with more than one group the dq sum. Its
    scratch: the stats (two floats a padded query row of each pair), then
    the blocks' dq sums where more groups or the accumulator's place ask
    for them."""
    (rows, smem, _, key_tile, step, threads, fixed, acc_row,
     max_smem) = _SBWD_LAYOUT
    if Lq <= rows and Lk <= rows:
        return {"form": "one_launch", "launches": 1, "groups": 1,
                "grid": B * H, "smem_bytes": smem, "scratch_floats": 0}
    key_tiles = -(-Lk // key_tile)
    if groups is None:
        groups = stream_bwd_groups(B * H, key_tiles, sm_count, causal)
    if not 1 <= groups <= key_tiles:
        raise ValueError(f"{groups} groups of {key_tiles} key tiles")
    tiles = -(-key_tiles // groups)
    groups = -(-key_tiles // tiles)   # none empty
    lq_pad = -(-Lq // step) * step
    in_smem = fixed + lq_pad * acc_row <= max_smem
    items = B * H * groups
    sums = items * lq_pad * acc_row // 4 if groups > 1 or not in_smem else 0
    return {"form": "key_groups", "launches": 2 + (groups > 1),
            "groups": groups, "tiles": tiles, "grid": items,
            "threads": threads, "lq_pad": lq_pad, "acc_in_smem": in_smem,
            "smem_bytes": fixed + (lq_pad * acc_row if in_smem else 0),
            "scratch_floats": 2 * B * H * lq_pad + sums}


def streaming_attention_bwd_cuda(q, k, v, do, o, lse, num_heads: int,
                                 causal: bool = False):
    """Launch csrc/streaming_attention_bwd.cu on the current stream (no
    sync), in the form of `streaming_bwd_plan`, or for float32 its form in
    csrc/attention_f32.cu. Returns dq, dk, dv."""
    # launch-bound at the text shape, like the forward: the device, the
    # stream and the current device are asked for once each
    from ._cuda import load_library
    _check_kernel_args(q, k, v, num_heads)
    B, Lq, D = q.shape
    Lk = k.shape[1]
    _check_bwd_args(q, do, o, lse, (B, num_heads, Lq))
    do, o, lse = do.contiguous(), o.contiguous(), lse.contiguous()
    if q.dtype == torch.float32:
        return _bwd_f32("streaming_attention_bwd_f32", q, k, v, do, (o, lse),
                        num_heads, causal)
    lib = load_library("streaming_attention_bwd")
    dev = q.device
    dq = torch.empty((B, Lq, D), dtype=q.dtype, device=dev)
    dk = torch.empty((B, Lk, D), dtype=q.dtype, device=dev)
    dv = torch.empty((B, Lk, D), dtype=q.dtype, device=dev)
    if B == 0 or Lq == 0 or Lk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    _check_layout("streaming_attention_bwd", lib,
                  "streaming_attention_bwd_layout", _SBWD_LAYOUT)
    # the SM count only where the plan reads it (past one key tile)
    if Lq <= _SBWD_LAYOUT[0] and Lk <= _SBWD_LAYOUT[0]:
        plan = streaming_bwd_plan(B, Lq, Lk, num_heads)
    else:
        plan = streaming_bwd_plan(
            B, Lq, Lk, num_heads,
            torch.cuda.get_device_properties(dev).multi_processor_count,
            causal=bool(causal))
    scratch = torch.empty(plan["scratch_floats"], dtype=torch.float32,
                          device=dev) if plan["scratch_floats"] else None
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        err = lib.streaming_attention_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            o.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if scratch is None else scratch.data_ptr(),
            B, Lq, Lk, num_heads, D // num_heads, *_qkv_strides(q, k, v),
            (D // num_heads) ** -0.5, int(causal),
            1 if plan["form"] == "one_launch" else 2, plan["groups"],
            plan.get("tiles", 1), plan.get("lq_pad", 0),
            int(plan.get("acc_in_smem", False)), plan["smem_bytes"], stream)
    if err != 0:
        raise _launch_failed("streaming_attention_bwd", lib, err)
    launch_counts["streaming_attention_bwd"] += 1
    stream_bwd_launches[plan["form"]] += plan["launches"]
    return dq, dk, dv


# Launch plans of csrc/attention_f32.cu, the float32 forms. B7's backward
# past one key tile ('key_groups'): key tiles of 128, steps of 64 query rows
# whose q / do stages and ds^T take the 3xTF32 backward's tiles to 208,896
# bytes, and the dq reduction's 256 threads a block. The 3xTF32 forward (B1
# / B6a, B8's first launch, and B7's forward at every length): 64 query rows
# and 128 threads a block, two stages of key / value tiles. The 3xTF32
# backward (B6b, B8's second launch): one block of 256 threads per (batch
# row, head) holds that head's fp32 dq accumulator and row statistics, 74
# floats per query row (Lq rounded up to 16), beside 154 KB of tile stages;
# past a block's 227 KB (Lq > 240) they move to a block-private region of a
# global scratch buffer, and a grid of one block per SM walks the (row,
# head) pairs. B7's backward takes the same kernel in its streaming form,
# in one launch while Lq and Lk are at most one key tile (128), its
# accumulator in shared memory, else in key groups. The attention of the
# w8a8 fusion's fp32 forms (B4, B11, B12; 'fma_fwd'): 7 warps of 16 query
# rows a block (112 rows, 224 threads), its q rows, one key and one value
# tile of 64 rows, the warps' e rows and the int8 form's scales and codes in
# 112,320 bytes, two blocks to an SM. The launch holds the fifteen numbers against the
# library's `attention_f32_layout` before its first use.
_F32_LAYOUT = (128, 64, 256, 208896,             # B7 backward's key groups
               64, 128, 69632,                   # 3xTF32 forward
               256, 157696, 74, 232448,          # 3xTF32 backward
               128,                              # its streaming form's rows
               112, 224, 112320)                 # the w8a8 fusion's forward
_CUDA_MAX_GRID_YZ = 65535


def stream_bwd_groups(items: int, key_tiles: int, slots: int,
                      causal: bool = False) -> int:
    """The groups of key tiles B7's fp32 backward cuts each of its `items`
    (batch row, head) pairs into: the fewest (at most one a key tile) whose
    blocks fill the card's `slots` (blocks it runs at once) to 85% over the
    waves they take, else the count that fills them best. Under the causal
    mask, with fewer pairs than slots, one group a key tile: the first key
    tile walks every query tile, so the item that holds it sets the time."""
    if causal and items < slots:
        return key_tiles
    fill = [(items * g / (-(-items * g // slots) * slots), g)
            for g in range(1, key_tiles + 1)]
    return next((g for f, g in fill if f >= 0.85), max(fill)[1])


def attention_f32_plan(B: int, Lq: int, Lk: int, H: int,
                       Dh: int = _KERNEL_HEAD_DIM, packed: bool = True,
                       sm_count: int = 132, groups: Optional[int] = None,
                       causal: bool = False) -> Dict:
    """The launches of the float32 kernels at one shape on a card of
    `sm_count` SMs. packed (the clamp form, whose path ends at 640 keys):
    {'fwd': {'grid': (query tiles, H, B), 'threads', 'smem_bytes'}, 'bwd':
    {'lq_pad', 'grid', 'acc_in_smem', 'smem_bytes', 'scratch_floats'},
    'fma_fwd': {'grid': (query blocks, H, B), 'threads', 'smem_bytes'}}, the
    backward's grid one-dimensional, 'fma_fwd' the attention of B4 / B11 /
    B12 (a block per 112 query rows); streaming: {'fwd', 'bwd'}, the
    forward the packed one's kernel (a block per 64 query rows) in its
    streaming form, and the backward the packed backward's kernel in its
    streaming form: {'form', 'launches', 'groups', 'grid', 'threads',
    'lq_pad', 'acc_in_smem', 'smem_bytes', 'scratch_floats'}, a block per
    (batch row, head, group of key tiles of 128). 'one_launch' while Lq and
    Lk are at most one key tile (one group, the accumulator in shared
    memory), else 'key_groups', `groups` (default `stream_bwd_groups`)
    cutting each pair's key tiles: one group (one launch; the accumulator in
    shared memory while it fits, else in a block-private region of the
    scratch, the grid at most one block an SM, walking the pairs), or more
    (two launches: the item-private dq sums in the scratch, then the dq
    reduction); `causal` counts in the default groups alone."""
    fma_fwd = attention_fma_plan(B, Lq, Lk, H, Dh)
    if packed and Lk > _PACKED_MAX_LK:
        raise ValueError(f"{Lk} keys: the packed path ends at "
                         f"{_PACKED_MAX_LK} (longer keys stream)")
    bwd_threads, fixed, per_row, max_smem, one_rows = _F32_LAYOUT[7:12]
    rows, threads, fwd_smem = _F32_LAYOUT[4:7]
    fwd = {"grid": (-(-Lq // rows), H, B), "threads": threads,
           "smem_bytes": fwd_smem}
    lq_pad = -(-Lq // 16) * 16
    acc = lq_pad * per_row
    in_smem = fixed + 4 * acc <= max_smem
    if not packed:
        one = Lq <= one_rows and Lk <= one_rows
        if not one:   # the key groups' 64-row steps
            fixed = _F32_LAYOUT[3]
            in_smem = fixed + 4 * acc <= max_smem
        key_tiles = -(-Lk // _F32_LAYOUT[0])
        if groups is None:   # a block fits an SM
            groups = 1 if one else stream_bwd_groups(B * H, key_tiles,
                                                     sm_count, causal)
        if not 1 <= groups <= key_tiles:
            raise ValueError(f"{groups} groups of {key_tiles} key tiles")
        groups = -(-key_tiles // -(-key_tiles // groups))   # none empty
        items = B * H * groups
        if groups > 1:
            grid, scratch = items, items * acc
        elif in_smem:
            grid, scratch = items, 0
        else:
            grid = min(items, sm_count)
            scratch = grid * acc
        bwd = {"form": "one_launch" if one else "key_groups",
               "launches": 1 if groups == 1 else 2, "groups": groups,
               "grid": grid, "threads": bwd_threads, "lq_pad": lq_pad,
               "acc_in_smem": in_smem,
               "smem_bytes": fixed + (4 * acc if in_smem else 0),
               "scratch_floats": scratch}
        return {"fwd": fwd, "bwd": bwd}
    if in_smem:
        bwd = {"lq_pad": lq_pad, "grid": B * H, "acc_in_smem": True,
               "smem_bytes": fixed + 4 * acc, "scratch_floats": 0}
    else:
        grid = min(B * H, sm_count)
        bwd = {"lq_pad": lq_pad, "grid": grid, "acc_in_smem": False,
               "smem_bytes": fixed, "scratch_floats": grid * acc}
    bwd["threads"] = bwd_threads
    return {"fwd": fwd, "bwd": bwd, "fma_fwd": fma_fwd}


def attention_fma_plan(B: int, Lq: int, Lk: int, H: int,
                       Dh: int = _KERNEL_HEAD_DIM) -> Dict:
    """The launch of the w8a8 fusion's fp32 attention (fma_fwd_kernel of
    csrc/attention_f32.cu: B4, B11, B12) at one shape: {'grid': (query
    blocks, H, B), 'threads', 'smem_bytes'}, a block per 112 query rows.
    Its key and value tiles of 64 rows stream whatever Lk, so it takes any
    key length (JAX's kernel holds whole padded key rows, with no limit)."""
    if Dh != _KERNEL_HEAD_DIM:
        raise ValueError(f"head dim {Dh}: the kernels are built for "
                         f"{_KERNEL_HEAD_DIM}")
    if min(B, Lq, Lk, H) < 1:
        raise ValueError(f"attention_f32 plan: B={B}, Lq={Lq}, Lk={Lk}, "
                         f"H={H}")
    if max(B, H) > _CUDA_MAX_GRID_YZ:
        raise ValueError(f"B={B}, H={H}: a grid's y and z take at most "
                         f"{_CUDA_MAX_GRID_YZ}")
    fma_rows, fma_threads, fma_smem = _F32_LAYOUT[12:]
    return {"grid": (-(-Lq // fma_rows), H, B), "threads": fma_threads,
            "smem_bytes": fma_smem}


def _f32_launch(name: str, dev, *args, count: bool = True) -> None:
    """Call entry `name` of csrc/attention_f32.cu on the current stream and
    count one launch of it (`count` False: the caller counts its own).
    Lean, as the bf16 wrapper: the raw stream, no device switch when `dev`
    is current, the layout checked at the first call."""
    from ._cuda import load_library
    lib = load_library("attention_f32")
    _check_layout("attention_f32", lib, "attention_f32_layout", _F32_LAYOUT)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise _launch_failed(name, lib, err)
    if count:
        launch_counts[name] += 1


def _packed_fwd_f32(name: str, q, k, v, num_heads: int):
    """B1 (`name` 'packed_attention_f32': out) or B6a
    ('packed_attention_den_f32': out, den) in float32."""
    B, Lq, D = q.shape
    with_den = name == "packed_attention_den_f32"
    out = torch.empty((B, Lq, D), dtype=q.dtype, device=q.device)
    den = torch.empty((B, Lq, num_heads), dtype=torch.float32,
                      device=q.device) if with_den else None
    if B and Lq:
        Dh = D // num_heads
        attention_f32_plan(B, Lq, k.shape[1], num_heads, Dh)
        _f32_launch(name, q.device, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(),
                    *((den.data_ptr(),) if with_den else ()), B, Lq,
                    k.shape[1], num_heads, Dh, *_qkv_strides(q, k, v),
                    out.stride(0), out.stride(1), Dh ** -0.5 * _LOG2E)
    return (out, den) if with_den else out


def _streaming_fwd_f32(q, k, v, num_heads: int, causal: bool):
    """B7's forward in float32: (out, lse (B, H, Lq)). Launch-bound at the
    text shape: the plan is computed only where it bounds an argument (B or
    H past the grid's y / z limit)."""
    B, Lq, D = q.shape
    dev = q.device
    out = torch.empty((B, Lq, D), dtype=q.dtype, device=dev)
    lse = torch.empty((B, num_heads, Lq), dtype=torch.float32, device=dev)
    if B == 0 or Lq == 0:
        return out, lse
    if max(B, num_heads) > _CUDA_MAX_GRID_YZ:
        attention_f32_plan(B, Lq, k.shape[1], num_heads, packed=False)
    Dh = D // num_heads
    _f32_launch("streaming_attention_f32", dev, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), lse.data_ptr(), B, Lq,
                k.shape[1], num_heads, Dh, *_qkv_strides(q, k, v),
                out.stride(0), out.stride(1), Dh ** -0.5, int(causal))
    return out, lse


def _bwd_f32(name: str, q, k, v, do, extra, num_heads: int, causal=None):
    """Allocate the gradients and the plan's scratch and launch entry
    `name` of csrc/attention_f32.cu: B6b (`extra` o, den), B8 (the scratch
    of the rebuilt o and den) or, with `causal` given, B7's backward (o,
    lse). do and the tensors of `extra` are contiguous."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    do = do.contiguous()
    dq = torch.empty((B, Lq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Lk, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Lk, D), dtype=q.dtype, device=q.device)
    if B == 0 or Lq == 0 or Lk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    Dh = D // num_heads
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = attention_f32_plan(B, Lq, Lk, num_heads, Dh, packed=causal is None,
                              sm_count=sms, causal=bool(causal))["bwd"]
    n_scratch = plan["scratch_floats"]
    launch = (plan["lq_pad"], plan["grid"], int(plan["acc_in_smem"]),
              plan["smem_bytes"])
    tail = (*launch, Dh ** -0.5) if causal is None else (
        Dh ** -0.5, int(causal), plan["groups"], *launch)
    scratch = torch.empty(n_scratch, dtype=torch.float32,
                          device=q.device) if n_scratch else None
    _f32_launch(name, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), *(t.data_ptr() for t in extra), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(),
                None if scratch is None else scratch.data_ptr(), B, Lq, Lk,
                num_heads, Dh, *_qkv_strides(q, k, v), *tail)
    if causal is not None:
        stream_bwd_f32_launches[plan["form"]] += plan["launches"]
    return dq, dk, dv


def _by_device(t: torch.Tensor, plain, cuda, what: str):
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if _force_plain or t.device.type == "cpu":
        return plain
    if t.device.type == "cuda":
        return cuda
    raise ValueError(f"no {what} for device {t.device}")


class _PackedAttention(torch.autograd.Function):
    """Differentiable packed attention (JAX `_packed_flash_saved`): the
    forward saves q, k, v, its output and the denominators; the backward is
    one more kernel."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, keep=None):
        fwd = _by_device(q, packed_attention_den_plain,
                         packed_attention_den_cuda, "packed attention")
        out, den = fwd(q, k, v, num_heads)
        ctx.save_for_backward(q, k, v, out, den)
        ctx.num_heads = num_heads
        if keep is not None:
            keep["out"], keep["den"] = out.detach(), den
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, den = ctx.saved_tensors
        bwd = _by_device(q, packed_attention_bwd_plain,
                         packed_attention_bwd_cuda, "packed attention")
        dq, dk, dv = bwd(q, k, v, do, out, den, ctx.num_heads)
        return dq, dk, dv, None, None


class _PackedAttentionReplay(torch.autograd.Function):
    """The packed attention of a block that is being recomputed for its
    backward while the first forward's results were kept (`keep` of
    `flash_attention`): it launches no forward kernel, hands back the kept
    output and saves what the mode's backward reads, the kept denominators
    included."""

    @staticmethod
    def forward(ctx, q, k, v, out, den, num_heads: int):
        if den is None:
            ctx.save_for_backward(q, k, v)
        else:
            ctx.save_for_backward(q, k, v, out, den)
        ctx.num_heads = num_heads
        return out.view_as(out)

    @staticmethod
    def backward(ctx, do):
        if len(ctx.saved_tensors) == 3:
            q, k, v = ctx.saved_tensors
            bwd = _by_device(q, packed_attention_bwd_recompute_plain,
                             packed_attention_bwd_recompute_cuda,
                             "packed attention")
            dq, dk, dv = bwd(q, k, v, do, ctx.num_heads)
        else:
            q, k, v, out, den = ctx.saved_tensors
            bwd = _by_device(q, packed_attention_bwd_plain,
                             packed_attention_bwd_cuda, "packed attention")
            dq, dk, dv = bwd(q, k, v, do, out, den, ctx.num_heads)
        return dq, dk, dv, None, None, None


class _PackedAttentionRecompute(torch.autograd.Function):
    """Differentiable packed attention that saves q, k, v only (JAX
    `_packed_flash_recompute`): the forward is the one that writes no
    denominators, the backward rebuilds output and denominators."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, keep=None):
        fwd = _by_device(q, packed_attention_plain, packed_attention_cuda,
                         "packed attention")
        ctx.save_for_backward(q, k, v)
        ctx.num_heads = num_heads
        out = fwd(q, k, v, num_heads)
        if keep is not None:
            keep["out"], keep["den"] = out.detach(), None
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        bwd = _by_device(q, packed_attention_bwd_recompute_plain,
                         packed_attention_bwd_recompute_cuda,
                         "packed attention")
        dq, dk, dv = bwd(q, k, v, do, ctx.num_heads)
        return dq, dk, dv, None, None


# which backward the packed path takes: 'saved' or 'recompute', read at
# every call
_BWD_MODE = os.environ.get("GAVA_FLASH_BWD", "saved")


def set_flash_bwd_mode(mode: str) -> None:
    """'saved' (default: the backward consumes the forward's output and
    per-head denominators) or 'recompute' (the backward rebuilds them; only
    q, k, v are kept). Affects calls made after it."""
    global _BWD_MODE
    if mode not in ("saved", "recompute"):
        raise ValueError(f"mode must be 'saved' or 'recompute', got {mode!r}")
    _BWD_MODE = mode


# ---------------------------------------------------------------------------
# clamp drift monitor (debug mode)
# ---------------------------------------------------------------------------
# The one-pass softmax replaces max subtraction by a clamp of the exp2
# argument at 110: exact while the scaled scores stay below it, silently
# flattening the weighting between keys above it. Nothing on the kernel path
# sees a trained tower drift past the clamp, so this opt-in monitor computes
# the exact largest exp2 argument outside the kernel (one more fp32 score
# product per call).

_monitor_enabled = False
clamp_stats = {"max_exp2_arg": 0.0, "clipped": False, "calls": 0}
# running maximum per device, fetched by read_clamp_stats
_clamp_max: Dict[torch.device, torch.Tensor] = {}


def enable_clamp_monitor(enabled: bool = True) -> None:
    """Toggle the drift monitor and reset its statistics. Read at every
    call of `flash_attention`."""
    global _monitor_enabled
    _monitor_enabled = bool(enabled)
    _clamp_max.clear()
    clamp_stats.update(max_exp2_arg=0.0, clipped=False, calls=0)


def read_clamp_stats() -> Dict:
    """Fetch the running maximum from the device(s) into `clamp_stats` and
    return it: the one host sync of the monitor."""
    for t in _clamp_max.values():
        m = float(t)
        if m > clamp_stats["max_exp2_arg"]:
            clamp_stats["max_exp2_arg"] = m
    clamp_stats["clipped"] = clamp_stats["max_exp2_arg"] >= _CLAMP
    return clamp_stats


def _monitor_clamp(q: torch.Tensor, k: torch.Tensor, num_heads: int) -> None:
    """The clamp is one-sided (min(s * c, 110) saturates positive scores
    only), so only the positive maximum counts: a large negative score
    underflows exp2 harmlessly."""
    Dh = q.shape[-1] // num_heads
    c = Dh ** -0.5 * _LOG2E
    with torch.no_grad():
        s = _heads(q, num_heads).float() @ \
            _heads(k, num_heads).float().transpose(-1, -2)
        m = torch.clamp(s.max(), min=0.0) * c
        seen = _clamp_max.get(q.device)
        _clamp_max[q.device] = m if seen is None else torch.maximum(seen, m)
    clamp_stats["calls"] += 1


class _StreamingAttention(torch.autograd.Function):
    """Differentiable streaming attention (JAX `_streaming_flash`): the
    forward saves q, k, v, its output and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, causal: bool):
        fwd = _by_device(q, streaming_attention_plain,
                         streaming_attention_cuda, "streaming attention")
        out, lse = fwd(q, k, v, num_heads, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.num_heads, ctx.causal = num_heads, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = _by_device(q, streaming_attention_bwd_plain,
                         streaming_attention_bwd_cuda, "streaming attention")
        dq, dk, dv = bwd(q, k, v, do, out, lse, ctx.num_heads, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int = 12, causal: bool = False,
                    keep: Optional[Dict] = None) -> torch.Tensor:
    """Self-attention over packed (B, L, H*Dh) q/k/v (JAX `flash_attention`).

    Non-causal with Lk <= 640 is the packed whole-row path; causal or
    longer keys the streaming path. Both are differentiable with kernel
    backward passes. Where no gradient is wanted (under `torch.no_grad()`,
    or none of q, k, v requires one) the packed path runs the forward that
    writes no denominators.

    keep: a dict that outlives a rematerialized block (models/vision.py,
    remat='save_attn'). The first differentiated packed call stores its
    output (and denominators) there; a later call with the filled dict, the
    block's recomputation, launches no forward kernel and hands the kept
    output back, so only q, k, v are rebuilt."""
    wants_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if not causal and k.shape[1] <= _PACKED_MAX_LK:
        if _monitor_enabled:
            _monitor_clamp(q, k, num_heads)
        if wants_grad:
            if keep:
                return _PackedAttentionReplay.apply(
                    q, k, v, keep["out"], keep["den"], num_heads)
            fn = _PackedAttentionRecompute if _BWD_MODE == "recompute" \
                else _PackedAttention
            return fn.apply(q, k, v, num_heads, keep)
        return _by_device(q, packed_attention_plain, packed_attention_cuda,
                          "packed attention")(q, k, v, num_heads)
    if wants_grad:
        return _StreamingAttention.apply(q, k, v, num_heads, causal)
    return _by_device(q, streaming_attention_plain, streaming_attention_cuda,
                      "streaming attention")(q, k, v, num_heads, causal)[0]


# ---------------------------------------------------------------------------
# w8a8 serving fusion: attention + int8 out-projection + residual
# ---------------------------------------------------------------------------

# Launch plan of csrc/attention_out_int8.cu: bytes of a K/V ring stage (64
# keys of K and V, 144-byte rows), its stages, threads per block (7 warps,
# one 16-row query slab each), the kernel's static shared bytes, bytes of
# the W^T ring; then the query rows per block (the out-projection's wgmma
# N). The launch holds the five constants against the library's
# `attention_out_int8_layout` before its first use.
_ATTN_OUT_LAYOUT = (18432, 4, 224, 128, 24576)
_ATTN_OUT_ROWS = 112


def attention_out_plan(B: int, lq: int, num_heads: int,
                       smem_limit: int) -> Dict:
    """Grid, shared bytes and scratch of one launch of the fused attention +
    int8 out-projection: {'rows' (query rows per block), 'grid' (query
    chunks, frame rows), 'per_sm' (blocks an SM holds at once),
    'smem_bytes', 'scratch' (the shape of the fp32 attention outputs that
    wait there for their row's scale)}. A block of 112 rows holds their
    int8 codes of the whole H*64-wide attention output, in the space its
    K/V ring used, beside the W^T ring: at 12 heads two blocks share an SM,
    and a 197-token frame row takes two."""
    from .int8_matmul import _BLOCK_RESERVED_SMEM, _SM90_SMEM_PER_SM
    D = num_heads * _KERNEL_HEAD_DIM
    if min(B, lq, num_heads) <= 0 or D > 1024:
        raise ValueError(f"attention_out_int8 plan: B={B}, lq={lq}, "
                         f"H={num_heads}")
    stage, stages, _, static, wring = _ATTN_OUT_LAYOUT
    rows = _ATTN_OUT_ROWS
    dp = -(-D // 128) * 128
    # the K/V ring, then in its space the code tile; the W^T ring; row
    # scales; the key scales
    smem = (1024 + max(rows * dp, stages * stage) + wring + 4 * rows
            + 4 * stages * 64)
    if smem + static > smem_limit:
        raise ValueError(f"attention_out_int8: rows of {D} codes do not fit "
                         f"the kernel's shared memory ({smem_limit} bytes)")
    need = smem + static + _BLOCK_RESERVED_SMEM
    chunks = -(-lq // rows)
    return {"rows": rows, "grid": (chunks, B),
            "per_sm": 2 if 2 * need <= _SM90_SMEM_PER_SM else 1,
            "smem_bytes": smem, "scratch": (B, chunks * rows, D)}


def _attention_out_launch(fn: str, q, k, v, wt, extra, num_heads: int,
                          out_params: Dict, residual, lq: int, tail):
    """Check the out-projection's leaves and the residual, allocate the
    output and launch entry `fn` of csrc/attention_out_int8.cu with its
    launch plan; `extra` are the pointers between v and W (the second
    source's k2, v2), `tail` the sizes, strides and constants between the
    output's pointer and the plan. Returns the output (no launch for an
    empty one)."""
    from ._cuda import load_library
    from .int8_matmul import _tma_rows, smem_limit
    B, _, D = q.shape
    kernel = out_params["kernel"]
    scale, bias = kernel["scale"], out_params["bias"]
    for name, t in (("out kernel", wt), ("scale", scale), ("bias", bias),
                    ("residual", residual)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if tuple(residual.shape) != (B, lq, D) or residual.dtype != q.dtype:
        raise ValueError(f"residual {residual.dtype} "
                         f"{tuple(residual.shape)}, expected ({B}, {lq}, "
                         f"{D}) {q.dtype}")
    scale = scale.reshape(-1).float().contiguous()
    bias = bias.reshape(-1).float().contiguous()
    r = residual.contiguous()
    out = torch.empty((B, lq, D), dtype=q.dtype, device=q.device)
    if B == 0 or lq == 0:
        return out
    lib = load_library("attention_out_int8")
    plan = attention_out_plan(
        B, lq, num_heads,
        smem_limit(lib, "attention_out_int8_layout", _ATTN_OUT_LAYOUT,
                   q.device))
    wt = _tma_rows(wt)
    a32 = torch.empty(plan["scratch"], dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = getattr(lib, fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *(t.data_ptr() for t in extra), wt.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), r.data_ptr(), out.data_ptr(), a32.data_ptr(),
            *tail, plan["rows"], plan["smem_bytes"], stream)
    if err != 0:
        raise _launch_failed(fn, lib, err)
    return out


def attention_out_int8_plain(q, k, v, num_heads: int, out_params: Dict,
                             residual: torch.Tensor,
                             lq: Optional[int] = None,
                             int8_qk: bool = False) -> torch.Tensor:
    """Plain version of csrc/attention_out_int8.cu: residual +
    w8a8_linear(attention(q[:, :lq], k, v)) with the attention output kept
    in fp32 up to its per-row quant; int8_qk takes the int8 score
    product."""
    from .int8_matmul import int_matmul, quant_rows, rescale
    lq = q.shape[1] if lq is None else lq
    a = _onepass_attention_den_f32(q[:, :lq], k, v, num_heads, int8_qk)[0]
    codes, xs = quant_rows(a)
    kernel = out_params["kernel"]
    y = rescale(int_matmul(codes, kernel["qa"]), xs, kernel["scale"],
                out_params["bias"])
    return (y + residual.float()).to(residual.dtype)


def attention_out_int8_cuda(q, k, v, num_heads: int, out_params: Dict,
                            residual: torch.Tensor,
                            lq: Optional[int] = None,
                            int8_qk: bool = False) -> torch.Tensor:
    """Launch csrc/attention_out_int8.cu on the current stream (no sync):
    its fp32-score entry point, or with int8_qk its int8 QK^T one; float32
    q/k/v take the fp32 form of either (`_attention_out_f32`)."""
    from .int8_matmul import _kernel_weight
    _check_kernel_args(q, k, v, num_heads)
    B, Lq_arr, D = q.shape
    lq = Lq_arr if lq is None else lq
    if not 0 <= lq <= Lq_arr:
        raise ValueError(f"lq {lq} outside 0..{Lq_arr}")
    wt = _kernel_weight("attention_out_int8", out_params["kernel"], D, D)
    if q.dtype == torch.float32:
        return _attention_out_f32(q, k, v, num_heads, out_params, residual,
                                  lq, int8_qk)
    name = "attention_out_int8_qk8" if int8_qk else "attention_out_int8"
    c = (D // num_heads) ** -0.5 * _LOG2E
    out = _attention_out_launch(
        name + "_bf16", q, k, v, wt, (), num_heads, out_params, residual, lq,
        (B, lq, k.shape[1], num_heads, q.stride(0), q.stride(1), k.stride(0),
         k.stride(1), v.stride(0), v.stride(1),
         c / (127.0 * 127.0) if int8_qk else c))
    if B and lq:
        launch_counts[name] += 1
    return out


def _attention_out_f32(q, k, v, num_heads: int, out_params: Dict,
                       residual: torch.Tensor, lq: int, int8_qk: bool = False,
                       second=None) -> torch.Tensor:
    """B4, B11 (int8_qk) and B12 (`second` = (k2, v2): the keys [k; k2],
    the values [v; v2]) in float32, two launches: the fp32 forward of
    csrc/attention_f32.cu's fma_fwd_kernel (B1's function, its int8-score
    form, or either over two sources; every sum in the plain version's
    order, which the row quant behind them needs to stay within its
    limits) writes
    the attention of the first lq queries, kept in fp32,
    into a scratch (B, lq, D); then B2's fp32 form (csrc/w8a8_matmul.cu)
    quantizes each scratch row, runs the int8 out-projection and adds the
    bias and the fp32 residual, each step rounded as
    `_int8_outproj_epilogue` rounds it. One count for the pair:
    `attention_out_int8_2src_f32` with a second source (either score
    form), else `attention_out_int8_qk8_f32` or `attention_out_int8_f32`."""
    from .int8_matmul import _w8a8_matmul_launch
    B, _, D = q.shape
    if residual.device != q.device:
        raise ValueError(f"residual on {residual.device}, q on {q.device}")
    if tuple(residual.shape) != (B, lq, D) or residual.dtype != q.dtype:
        raise ValueError(f"residual {residual.dtype} "
                         f"{tuple(residual.shape)}, expected ({B}, {lq}, "
                         f"{D}) {q.dtype}")
    if B == 0 or lq == 0:
        return torch.empty((B, lq, D), dtype=q.dtype, device=q.device)
    Dh = D // num_heads
    # the exp2 constant; the int8-score form folds 1 / 127^2 into it
    c = Dh ** -0.5 * _LOG2E / (127.0 * 127.0 if int8_qk else 1.0)
    L2 = 0 if second is None else second[0].shape[1]
    attention_fma_plan(B, lq, k.shape[1] + L2, num_heads, Dh)
    a = torch.empty((B, lq, D), dtype=torch.float32, device=q.device)
    head = (q.device, q.data_ptr(), k.data_ptr(), v.data_ptr())
    if second is not None:
        k2, v2 = second
        name = "attention_out_int8_2src_f32"
        _f32_launch("packed_attention_2src_f32", *head, k2.data_ptr(),
                    v2.data_ptr(), a.data_ptr(), B, lq, k.shape[1], L2,
                    num_heads, Dh, *_qkv_strides(q, k, v), k2.stride(0),
                    k2.stride(1), v2.stride(0), v2.stride(1), a.stride(0),
                    a.stride(1), c, int(int8_qk), count=False)
    else:
        name = "attention_out_int8_qk8_f32" if int8_qk \
            else "attention_out_int8_f32"
        _f32_launch("packed_attention_qk8_f32" if int8_qk
                    else "packed_attention_fma_f32", *head, a.data_ptr(), B,
                    lq, k.shape[1], num_heads, Dh, *_qkv_strides(q, k, v),
                    a.stride(0), a.stride(1), c, count=False)
    out = _w8a8_matmul_launch("f32", a.view(B * lq, D), out_params["kernel"],
                              out_params["bias"],
                              residual.reshape(B * lq, D))
    launch_counts[name] += 1
    return out.view(B, lq, D)


def int8_qk_args_cuda(q: torch.Tensor, k: torch.Tensor,
                      num_heads: int) -> torch.Tensor:
    """The check entry of csrc/attention_f32.cu: the exp2 arguments (B, H,
    Lq, Lk) of the int8-score form's scores, before the clamp, for float32
    q (B, Lq, H*64) and k (B, Lk, H*64), computed by the kernel's own steps;
    `_int8_qk_exp2_arg` gives the same bits. It checks B11's codes and
    rescale and lies on no path: it counts no launch."""
    _check_kernel_args(q, k, k, num_heads)
    if q.dtype != torch.float32:
        raise TypeError(f"the int8 QK^T check takes float32 q/k, got "
                        f"{q.dtype}")
    B, Lq, D = q.shape
    Lk = k.shape[1]
    Dh = D // num_heads
    out = torch.empty((B, num_heads, Lq, Lk), dtype=torch.float32,
                      device=q.device)
    if B and Lq and Lk:
        attention_fma_plan(B, Lq, Lk, num_heads, Dh)
        _f32_launch("attention_f32_qk8_args", q.device, q.data_ptr(),
                    k.data_ptr(), out.data_ptr(), B, Lq, Lk, num_heads, Dh,
                    q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                    Dh ** -0.5 * _LOG2E / (127.0 * 127.0), count=False)
    return out


def flash_attention_out_int8(q, k, v, num_heads: int, out_params: Dict,
                             residual: torch.Tensor,
                             lq: Optional[int] = None,
                             impl: str = "kernel") -> torch.Tensor:
    """residual + Linear_w8a8(attention(q[:, :lq], k, v)) (JAX
    `flash_attention_out_int8`). q may be longer than lq (the full kv-row
    projection); the output has lq rows. impl='plain' runs the plain
    version on any device; 'kernel' the plain version on the CPU and the
    CUDA kernel on a card. The int8 QK^T switch (`set_int8_qk`) is read
    here, at every call.

    Any key length, as in JAX: the kernels stream key tiles of 64, and
    with no max subtraction each e is at most 2^110, so a denominator of
    802 keys (448^2 frames with 17 extras) stays below 2^120, inside
    fp32's range."""
    if impl == "plain" or q.device.type == "cpu":
        fn = attention_out_int8_plain
    elif impl != "kernel":
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    elif q.device.type == "cuda":
        fn = attention_out_int8_cuda
    else:
        raise ValueError(f"no attention kernel for device {q.device}")
    return fn(q, k, v, num_heads, out_params, residual, lq, _INT8_QK)


def attention_out_int8_2src_plain(q, k1, v1, k2, v2, num_heads: int,
                                  out_params: Dict, residual: torch.Tensor,
                                  int8_qk: bool = False) -> torch.Tensor:
    """Plain version of the two-source entry of csrc/attention_out_int8.cu:
    `attention_out_int8_plain` with the keys [k1; k2] and the values
    [v1; v2], every row of q a query."""
    return attention_out_int8_plain(
        q, torch.cat([k1, k2], dim=1), torch.cat([v1, v2], dim=1), num_heads,
        out_params, residual, None, int8_qk)


def attention_out_int8_2src_cuda(q, k1, v1, k2, v2, num_heads: int,
                                 out_params: Dict, residual: torch.Tensor,
                                 int8_qk: bool = False) -> torch.Tensor:
    """Launch the two-source entry of csrc/attention_out_int8.cu on the
    current stream (no sync), or for float32 q/k/v its fp32 form
    (`_attention_out_f32`); k1, v1 and k2, v2 are read where they lie."""
    from .int8_matmul import _kernel_weight
    _check_kernel_args(q, k1, v1, num_heads)
    _check_kernel_args(q, k2, v2, num_heads)
    B, Lq, D = q.shape
    L1, L2 = k1.shape[1], k2.shape[1]
    wt = _kernel_weight("attention_out_int8_2src", out_params["kernel"], D, D)
    if L1 + L2 == 0:
        raise ValueError("the fused attention needs at least one key")
    if q.dtype == torch.float32:
        return _attention_out_f32(q, k1, v1, num_heads, out_params, residual,
                                  Lq, int8_qk, (k2, v2))
    c = (D // num_heads) ** -0.5 * _LOG2E
    out = _attention_out_launch(
        "attention_out_int8_2src_bf16", q, k1, v1, wt, (k2, v2), num_heads,
        out_params, residual, Lq,
        (B, Lq, L1, L2, num_heads, q.stride(0), q.stride(1), k1.stride(0),
         k1.stride(1), v1.stride(0), v1.stride(1), k2.stride(0),
         k2.stride(1), v2.stride(0), v2.stride(1),
         c / (127.0 * 127.0) if int8_qk else c, int(int8_qk)))
    if B and Lq:
        launch_counts["attention_out_int8_2src"] += 1
    return out


def flash_attention_out_int8_2src(q, k1, v1, k2, v2, num_heads: int,
                                  out_params: Dict, residual: torch.Tensor,
                                  impl: str = "kernel") -> torch.Tensor:
    """`flash_attention_out_int8` over two separate key / value sources (JAX
    `flash_attention_out_int8_2src`): the keys are the union [k1; k2], so a
    caller whose second source is projected apart (prompt extras, a
    precomputed memory) never writes the (B, L1 + L2, D) concatenation.
    q, k1, v1, residual are (B, L1, D), k2, v2 (B, L2, D). Inference only.
    The int8 QK^T switch (`set_int8_qk`) is read here, at every call. Any
    key count L1 + L2, as `flash_attention_out_int8`."""
    if impl == "plain" or q.device.type == "cpu":
        fn = attention_out_int8_2src_plain
    elif impl != "kernel":
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    elif q.device.type == "cuda":
        fn = attention_out_int8_2src_cuda
    else:
        raise ValueError(f"no attention kernel for device {q.device}")
    return fn(q, k1, v1, k2, v2, num_heads, out_params, residual, _INT8_QK)
