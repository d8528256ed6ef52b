"""Int8 GEMMs of the serving paths (port of the serving kernels in
gava_clip_tpu/ops/int8_matmul.py): the weight-only dequant GEMM of the w8
mode and the fused w8a8 ops.

Each op is a hand-written CUDA kernel for sm_90a beside a plain PyTorch
version of the same math:

  * `w8a8_matmul` (csrc/w8a8_matmul.cu, TPU `_w8a8_kernel`): per-row int8
    quant of x, int8 GEMM, `acc * xs * s + b`;
  * `w8a8_matmul3_cat` (csrc/w8a8_qkv.cu, TPU `_w8a8_kernel3_cat`): per
    clip the rows [x rows; extras rows], LayerNorm, ONE shared quant, three
    int8 GEMMs + bias (q/k/v); its launch plan is `w8a8_qkv_plan`;
  * `w8a8_matmul3` (the same kernel with no extras rows, TPU
    `_w8a8_kernel3`): (M, K) rows, the LayerNorm optional, one shared quant,
    three int8 GEMMs + bias: a w8a8 self-attention's q/k/v projections
    (`ops/attention.multi_head_attention`);
  * `w8a8_mlp_res` (csrc/w8a8_mlp.cuh, built by w8a8_mlp.cu and its fp32
    form by w8a8_mlp_f32.cu; TPU `kernel` in `w8a8_mlp_res`):
    LayerNorm, quant, int8 fc1 + bias, QuickGELU on the fp32 hidden,
    requant over the whole hidden row, int8 fc2 + bias + residual;
  * `w8a8_mlp` (a second entry point of the same sources, TPU
    `_w8a8_mlp_kernel`): the same without the residual, the LayerNorm
    optional (`ln=None` quantizes the input rows as they are);
  * `int8_matmul` / `quantized_linear` (csrc/w8_matmul.cu, its fp32 form
    csrc/w8_matmul_f32.cu; TPU `_kernel`): the weight-only GEMM x @
    dtype(f32(w_q) * scale) with fp32 accumulation. The weight is
    dequantized with ONE rounding per element (the fp32 product cast to
    x's dtype), as the TPU kernel does, not with the scale rounded first
    as the JAX XLA fallback does. The bias is added after the kernel, in
    the output dtype: two roundings.

The plain versions of the w8a8 ops follow the KERNEL semantics, not the
JAX XLA fallback `quantize_act` (which divides by xs and clips): the row
scale is
xs = max(absmax, 1e-6) * fp32(1/127), the codes are rint(x * (1/xs)) with
no clip; LayerNorm is fp32 with two-pass biased variance, eps 1e-5; bias
and residual are added in fp32 and only the final store is cast. The
integer products are exact: int8 x int8 sums reach 127^2 * 3072 > 2^24, so
they run in float64 (exact below 2^53) on either device.

Each w8a8 op takes its weights as kernel leaves {'qa': int8 (K, N),
'scale': fp32 (1, N)}, the w8 GEMM as {'q', 'scale'}. The CUDA kernels read
the weight in a layout of their own from the leaf's 'qa_t' (W^T (N, K), k
contiguous) / 'q_t' (`w8_kernel_layout`: W^T cut into the w8 kernel's
weight tiles), which `with_kernel_layout` adds once where the weights are
placed on the card; a CUDA call on a leaf without it raises. 'q' / 'qa',
the plain versions and everything the bridge or a checkpoint sees keep the
JAX layout.

Dispatch: `impl="kernel"` (the default) runs the plain version for a CPU
tensor and the CUDA kernel for a CUDA tensor (or raises: there is no
fallback); `impl="plain"` runs the plain version on any device, which is
how a run holds the kernels against it on the card.

Dtypes: each w8a8 kernel and the w8 GEMM has a bf16 form and an fp32 form
(the TPU kernels emit their input's dtype), picked by the dtype of the
rows: all bfloat16 or all float32, the extras rows and the residual in the
rows' dtype, the output in it too. Nothing is cast from one to the other;
fp16 or mixed rows raise TypeError. The fp32 forms read fp32 rows and
store fp32 (launch counts `*_f32`). The w8a8 forms' arithmetic after the
load is the bf16 forms'; the w8 GEMM's fp32 form runs its products as
3xTF32 wgmma (each fp32 operand split into two TF32 parts, fp32 accuracy)
where the bf16 form runs bf16 wgmma.

Int8-forward training of frozen weights (`--int8_frozen`, JAX
`int8_linear_st`, `int8_qkv3_st`, `int8_mlp_st`) runs B2, B3a and B5 (or
their plain versions, by `impl`) inside three autograd functions whose
backwards compute dx alone by the JAX formulas; their leaves are the
frozen-training {'qt', 'scale'[, 'qt_t']}. On the card the kernels take
the step's rows in bf16 or in fp32. The generic JAX helpers
`quantize_act`, `int8_apply` and `int8_dynamic_linear` are ported beside
them.
"""

from typing import Dict, Optional, Sequence, Tuple

import torch

from .quant import dequantize_weight

_INV127 = 1.0 / 127.0     # applied as fp32(1/127), as the kernels do
_LN_EPS = 1e-5
# the w8 kernel's weight tile (csrc/w8_matmul.cu): 128 rows of W^T (columns
# of y) by 64 k, 8,192 bytes
_W8_TILE_N, _W8_TILE_K = 128, 64

# launches of each hand-written kernel since the last reset; `*_f32` counts
# the fp32 form of the kernel
launch_counts = {"w8a8_matmul": 0, "w8a8_matmul3_cat": 0, "w8a8_matmul3": 0,
                 "w8a8_mlp_res": 0, "w8a8_mlp": 0, "int8_matmul": 0,
                 "w8a8_matmul_f32": 0, "w8a8_matmul3_cat_f32": 0,
                 "w8a8_matmul3_f32": 0, "w8a8_mlp_res_f32": 0,
                 "w8a8_mlp_f32": 0, "int8_matmul_f32": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def ln_f32(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           eps: float = _LN_EPS) -> torch.Tensor:
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * scale.float() + \
        bias.float()


def quant_rows(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 codes (kept as float, exact integers) and the
    fp32 row scale xs (..., 1)."""
    xs = torch.clamp(x32.abs().amax(dim=-1, keepdim=True), min=1e-6) * \
        _INV127
    return torch.round(x32 * torch.reciprocal(xs)), xs


def quick_gelu_f32(h: torch.Tensor) -> torch.Tensor:
    return h * torch.sigmoid(1.702 * h)


def int_matmul(codes: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> integer products (float64), rounded once to
    fp32 as the kernels convert their int32 accumulators."""
    return (codes.double() @ w_q.double()).float()


def rescale(acc: torch.Tensor, xs: torch.Tensor, scale: torch.Tensor,
            bias: Optional[torch.Tensor]) -> torch.Tensor:
    y = acc * xs * scale.float().reshape(-1)
    return y if bias is None else y + bias.float()


def w8a8_matmul_plain(x, kernel, bias=None):
    codes, xs = quant_rows(x.float())
    return rescale(int_matmul(codes, kernel["qa"]), xs, kernel["scale"],
                   bias).to(x.dtype)


def _kv_rows(x, e):
    return x if e is None or e.shape[1] == 0 else torch.cat([x, e], dim=1)


def w8a8_matmul3_cat_plain(x, e, kernels3, bias3, ln):
    """ln None quantizes the rows as they are."""
    kv = _kv_rows(x, e).float()
    codes, xs = quant_rows(kv if ln is None else ln_f32(kv, *ln))
    return tuple(rescale(int_matmul(codes, k["qa"]), xs, k["scale"],
                         b).to(x.dtype) for k, b in zip(kernels3, bias3))


def w8a8_matmul3_plain(x, kernels3, bias3, ln=None):
    return tuple(o[0] for o in w8a8_matmul3_cat_plain(x[None], None,
                                                      kernels3, bias3, ln))


def _w8a8_mlp_f32(x, fc1, fc2, ln):
    """fc2(QuickGELU(fc1([LayerNorm](x)))) in fp32, before any residual."""
    x32 = x.float()
    codes, xs = quant_rows(x32 if ln is None else ln_f32(x32, *ln))
    k1, k2 = fc1["kernel"], fc2["kernel"]
    h = quick_gelu_f32(rescale(int_matmul(codes, k1["qa"]), xs,
                               k1["scale"], fc1["bias"]))
    hq, hs = quant_rows(h)
    return rescale(int_matmul(hq, k2["qa"]), hs, k2["scale"], fc2["bias"])


def w8a8_mlp_res_plain(x, fc1, fc2, ln, residual):
    return (_w8a8_mlp_f32(x, fc1, fc2, ln)
            + residual.float()).to(residual.dtype)


def w8a8_mlp_plain(x, fc1, fc2, ln=None):
    return _w8a8_mlp_f32(x, fc1, fc2, ln).to(x.dtype)


def dequant_weight(w_q: torch.Tensor, scale: torch.Tensor,
                   dtype) -> torch.Tensor:
    """The w8 kernel's weight: the fp32 product f32(w_q) * scale rounded
    once to `dtype`."""
    return (w_q.float() * scale.float()).to(dtype)


def int8_matmul_plain(x, w_q, scale):
    """x (M, K) @ dequant(w_q (K, N), scale (1, N)) -> (M, N) in x.dtype,
    the products summed in fp32 and cast once."""
    w = dequant_weight(w_q, scale, x.dtype)
    return (x.float() @ w.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _check_cuda(name: str, device, tensors) -> None:
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name} kernel needs every tensor on one "
                             f"CUDA device, got {device} and {t.device}")


def _f32_vec(t, n: int, what: str):
    t = t.reshape(-1)
    if t.numel() != n:
        raise ValueError(f"{what}: {n} values expected, got {t.numel()}")
    return t.float().contiguous()


def _rows_dtype(name: str, *rows) -> str:
    """The w8a8 kernels' dtype rule: the rows (and the extras rows, the
    residual: every tensor given, None skipped) all bfloat16 or all
    float32. Returns the suffix of the entry point and of the launch count
    of that form ('bf16' or 'f32'); anything else raises TypeError. Nothing
    is cast."""
    dtypes = {t.dtype for t in rows if t is not None}
    if len(dtypes) != 1 or not dtypes <= {torch.bfloat16, torch.float32}:
        raise TypeError(f"{name} kernel takes rows all bfloat16 or all "
                        f"float32, got {sorted(map(str, dtypes))}")
    return "f32" if dtypes == {torch.float32} else "bf16"


def _counted(name: str, form: str) -> str:
    """The launch count of `name` in form `form`."""
    return name if form == "bf16" else f"{name}_f32"


def _launch(lib_name: str, fn: str, device, *args) -> None:
    from ._cuda import load_library
    lib = load_library(lib_name)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        # 1 (invalid value) is also a tile that does not fit in shared
        # memory: the w8a8 kernels hold a block's rows of K codes there
        hint = " (or rows too long for the kernel's shared-memory tile)" \
            if err == 1 else ""
        raise RuntimeError(f"{fn} kernel launch failed: "
                           f"{lib.cuda_error_string(err).decode()} ({err})"
                           f"{hint}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def kernel_layout(w: torch.Tensor) -> torch.Tensor:
    """The int8 weight (K, N) as W^T (N, K) with k contiguous: the layout
    from which the w8a8 kernels load their W^T slabs by TMA
    (csrc/w8a8_wgmma.cuh)."""
    return w.t().contiguous()


def _w8_tiled_view(K: int, N: int):
    """Shape and permutation between W^T (N, K) padded to whole tiles and
    the w8 kernel's layout. W^T[n][k] with n = ((nb * 8 + slab) * 2 + r8) *
    8 + g and k = (((kb * 2 + h) * 2 + j) * 2 + kh) * 8 + t * 2 + e sits at
    [nb][kb][slab][h][g][t][j][kh][r8][e]: one tile (128 x 64) is 8,192
    contiguous bytes; in it, lane (g, t) of the warp of 16-row slab `slab`
    finds the A fragments of its k16 steps 2h and 2h + 1 as 16 contiguous
    bytes (for each step: rows g, g + 8 at k 2t, 2t + 1, then at k + 8)."""
    nb = -(-N // _W8_TILE_N)
    kb = -(-K // _W8_TILE_K)
    split = (nb, 8, 2, 8, kb, 2, 2, 2, 4, 2)   # nb slab r8 g kb h j kh t e
    perm = (0, 4, 1, 5, 3, 8, 6, 7, 2, 9)
    return nb, kb, split, perm


def w8_kernel_layout(w: torch.Tensor) -> torch.Tensor:
    """The int8 weight (K, N) in the w8 kernel's layout (csrc/w8_matmul.cu):
    (ceil(N / 128), ceil(K / 64), 8192) int8, W^T zero-padded to whole
    tiles, each tile in the order in which the kernel's warps read their A
    fragments (`_w8_tiled_view`)."""
    K, N = w.shape
    nb, kb, split, perm = _w8_tiled_view(K, N)
    wt = torch.zeros((nb * _W8_TILE_N, kb * _W8_TILE_K), dtype=w.dtype,
                     device=w.device)
    wt[:N, :K] = w.t()
    return wt.view(split).permute(perm).reshape(nb, kb,
                                                _W8_TILE_N * _W8_TILE_K)


def w8_layout_inverse(tiles: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """The (K, N) weight back from `w8_kernel_layout`."""
    nb, kb, split, perm = _w8_tiled_view(K, N)
    inv = [perm.index(i) for i in range(len(perm))]
    shaped = tiles.reshape([split[p] for p in perm]).permute(inv)
    return shaped.reshape(nb * _W8_TILE_N, kb * _W8_TILE_K)[:N, :K].t()


def with_kernel_layout(tree):
    """A copy of a param tree in which every w8a8 kernel leaf {'qa',
    'scale'} also carries 'qa_t' = kernel_layout(qa), every frozen-training
    leaf {'qt', 'scale'} 'qt_t' = kernel_layout(qt), and every w8 leaf
    {'q', 'scale'} 'q_t' = w8_kernel_layout(q). Made once, where the weights
    are placed on the device (the CUDA wrappers read only these copies; the
    plain versions only 'qa' / 'qt' / 'q')."""
    if isinstance(tree, list):
        return [with_kernel_layout(v) for v in tree]
    if not isinstance(tree, dict):
        return tree
    out = {k: with_kernel_layout(v) for k, v in tree.items()}
    for key, layout in (("qa", kernel_layout), ("qt", kernel_layout),
                        ("q", w8_kernel_layout)):
        if isinstance(tree.get(key), torch.Tensor) and "scale" in tree:
            out[key + "_t"] = layout(tree[key])
    return out


def _kernel_weight(name, kernel, K, N=None, key="qa_t"):
    """The W^T (N, K) int8 weight of a w8a8 kernel leaf, or (key 'q_t')
    the w8 kernel's tiles of a w8 leaf (N then required), checked."""
    if key not in kernel:
        raise ValueError(f"{name}: the kernel reads the weight in its own "
                         f"layout from the leaf's '{key}'; add it where the "
                         f"weights are placed "
                         f"(ops.int8_matmul.with_kernel_layout)")
    w = kernel[key]
    if key == "q_t":
        shape = _w8_tiled_view(K, N)[:2] + (_W8_TILE_N * _W8_TILE_K,)
        if w.dtype != torch.int8 or tuple(w.shape) != shape or \
                not w.is_contiguous():
            raise ValueError(f"{name}: contiguous int8 w8 kernel layout "
                             f"{shape} expected, got {w.dtype} "
                             f"{tuple(w.shape)}")
        return w
    if w.dtype != torch.int8 or w.dim() != 2 or w.shape[1] != K or \
            (N is not None and w.shape[0] != N) or not w.is_contiguous():
        raise ValueError(f"{name}: contiguous int8 W^T ({N or 'N'}, {K}) "
                         f"expected, got {w.dtype} {tuple(w.shape)}")
    return w


def w8a8_matmul_cuda(x, kernel, bias=None):
    """Launch csrc/w8a8_matmul.cu: x (M, K) bf16 or fp32 -> (M, N) in
    x's dtype."""
    form = _rows_dtype("w8a8_matmul", x)
    out = _w8a8_matmul_launch(form, x, kernel, bias, None)
    if x.shape[0]:
        launch_counts[_counted("w8a8_matmul", form)] += 1
    return out


def _w8a8_matmul_launch(form, x, kernel, bias, residual):
    """Check and launch B2's entry of form `form` ('bf16' or 'f32'): x (M,
    K) -> (M, N); fp32 only, a residual (M, N) fp32 added last (the fp32
    B4's out-projection). Counts nothing."""
    _check_cuda("w8a8_matmul", x.device,
                (x, kernel.get("qa_t"), kernel["scale"], bias, residual))
    x = x.contiguous()
    M, K = x.shape
    wt = _kernel_weight("w8a8_matmul", kernel, K)
    N = wt.shape[0]
    s = _f32_vec(kernel["scale"], N, "scale")
    b = None if bias is None else _f32_vec(bias, N, "bias")
    r = None if residual is None else residual.contiguous()
    if r is not None and tuple(r.shape) != (M, N):
        raise ValueError(f"residual {tuple(r.shape)}, expected ({M}, {N})")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M:
        from ._cuda import load_library
        layout, fn = (_B2_LAYOUT, "w8a8_matmul_layout") if form == "bf16" \
            else (_B2_LAYOUT_F32, "w8a8_matmul_layout_f32")
        plan = w8a8_matmul_plan(
            M, K, N,
            torch.cuda.get_device_properties(x.device).multi_processor_count,
            smem_limit(load_library("w8a8_matmul"), fn, layout, x.device),
            esize=x.element_size())
        head = (x.data_ptr(), _tma_rows(wt).data_ptr(), s.data_ptr(),
                _ptr(b))
        tail = (out.data_ptr(), M, K, N, plan["rows"], plan["units"],
                plan["stages"], plan["smem_bytes"])
        if form == "bf16":
            _launch("w8a8_matmul", "w8a8_matmul_bf16", x.device, *head,
                    *tail)
        else:
            _launch("w8a8_matmul", "w8a8_matmul_f32", x.device, *head,
                    _ptr(r), *tail)
    return out


def _w8a8_qkv_launch(name, x, e, kernels3, bias3, ln):
    """Launch csrc/w8a8_qkv.cu: x (B, Lx, K), e (B, Le, K) or None, bf16 or
    fp32 -> three (B, Lx + Le, N) in x's dtype; ln None skips the LayerNorm.
    Counts the launch under `name` (its `_f32` count in fp32)."""
    Le = 0 if e is None else e.shape[1]
    form = _rows_dtype(name, x, e if Le else None)
    _check_cuda(name, x.device,
                (x, e, *(k.get("qa_t") for k in kernels3),
                 *(k["scale"] for k in kernels3), *bias3, *(ln or ())))
    x = x.contiguous()
    B, Lx, K = x.shape
    if Le:
        e = e.contiguous()
        if e.shape[0] != B or e.shape[2] != K:
            raise ValueError(f"extras {tuple(e.shape)} vs x {tuple(x.shape)}")
    N = _kernel_weight(name, kernels3[0], K).shape[0]
    ws = [_kernel_weight(name, k, K, N) for k in kernels3]
    ss = [_f32_vec(k["scale"], N, "scale") for k in kernels3]
    bs = [_f32_vec(b, N, "bias") for b in bias3]
    g, beta = (None, None) if ln is None else \
        (_f32_vec(p, K, "LayerNorm") for p in ln)
    outs = [torch.empty((B, Lx + Le, N), dtype=x.dtype, device=x.device)
            for _ in range(3)]
    if B and Lx + Le:
        from ._cuda import load_library
        plan = w8a8_qkv_plan(
            B * (Lx + Le), K, N,
            torch.cuda.get_device_properties(x.device).multi_processor_count,
            smem_limit(load_library("w8a8_qkv"), "w8a8_qkv_layout",
                       _QKV_LAYOUT, x.device))
        ws = [_tma_rows(w) for w in ws]
        _launch("w8a8_qkv", f"w8a8_qkv_cat_{form}", x.device, x.data_ptr(),
                _ptr(e) if Le else None, *(w.data_ptr() for w in ws),
                *(s.data_ptr() for s in ss), *(b.data_ptr() for b in bs),
                _ptr(g), _ptr(beta), *(o.data_ptr() for o in outs),
                B, Lx, Le, K, N, plan["rows"], plan["units"],
                plan["stages"], plan["smem_bytes"])
        launch_counts[_counted(name, form)] += 1
    return tuple(outs)


def w8a8_matmul3_cat_cuda(x, e, kernels3, bias3, ln):
    """Launch csrc/w8a8_qkv.cu: x (B, Lx, K), e (B, Le, K) or None, bf16 or
    fp32 -> three (B, Lx + Le, N) in x's dtype."""
    return _w8a8_qkv_launch("w8a8_matmul3_cat", x, e, kernels3, bias3, ln)


def w8a8_matmul3_cuda(x, kernels3, bias3, ln=None):
    """Launch csrc/w8a8_qkv.cu with no extras rows: x (M, K) bf16 or fp32
    -> three (M, N) in x's dtype; ln None skips the LayerNorm."""
    return tuple(o[0] for o in _w8a8_qkv_launch("w8a8_matmul3", x[None],
                                                None, kernels3, bias3, ln))


# the fused MLP's launch plan (csrc/w8a8_mlp.cuh): bytes of an fc1 weight
# tile (128 x 128), stages of the fc1 ring, most stages of the fc2 ring,
# bytes per row of the code staging tile, the kernel's static shared bytes,
# bytes of an fc2 weight tile (256 x 128); rows per block, largest first
_MLP_LAYOUT = (16384, 3, 4, 144, 256, 32768)
_MLP_ROWS = (192, 64)
# the fused q/k/v kernel's launch plan (csrc/w8a8_qkv.cu): bytes of one
# consumer warpgroup's ring stage (64 W^T rows x 128 k), most stages per
# ring, output columns per unit, the kernel's static shared bytes; rows per
# block (the wgmma N), largest first; the fewest ring stages a plan takes
_QKV_LAYOUT = (8192, 8, 128, 256)
_QKV_ROWS = (128, 64, 32)
_QKV_MIN_STAGES = 3
# the w8a8 GEMM's launch plan (csrc/w8a8_matmul.cu): bytes of one consumer
# warpgroup's ring stage (64 W^T rows x 128 k), most stages per ring, output
# columns per unit, bytes of the epilogue's staging tiles, the kernel's
# static shared bytes; the same of its fp32 form, whose epilogue stores
# from the registers (no staging tiles); rows per block (the wgmma N),
# largest first; the most rows a plan takes when no tile size gives every
# SM a block
_B2_LAYOUT = (8192, 8, 128, 8192, 256)
_B2_LAYOUT_F32 = (8192, 8, 128, 0, 256)
_B2_ROWS = (192, 128, 64, 32, 16, 8)
_B2_SMALL_ROWS = 32
# the tile the plan takes where those tiles give every SM but at most one a
# block (measured on an H100 at the patch embed, 25,088 x 768 -> 768, in
# CUDA graphs: 192 rows 0.0616 ms, 64 rows two blocks an SM 0.0693, 128
# rows 0.0841; utils/kernel_variants.py b2)
_B2_WIDE_ROWS = 192
# shared memory of one SM of an sm_90 card, and what the card reserves for
# each block beside its own bytes: two blocks of at most 64 rows share an SM
# where both fit
_SM90_SMEM_PER_SM = 233472
_BLOCK_RESERVED_SMEM = 1024
# the card's shared bytes per block, as a kernel library reports them
# beside its layout constants once they have been checked: (layout
# function, device) -> bytes
_layout_checked: Dict = {}


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def w8a8_mlp_plan(M: int, K: int, H: int, N: int, sm_count: int,
                  smem_limit: int) -> Dict:
    """Launch plan of the fused w8a8 MLP on a card of `sm_count` SMs whose
    blocks may have `smem_limit` shared bytes: {'rows' (per block), 'grid',
    'stages2' (fc2 ring), 'smem_bytes', 'scratch' (rows, columns of the
    int8 hidden codes)}. A block keeps its rows' K codes in shared memory:
    192 rows where that fits and still gives every SM a block, else 64.
    Raises for rows too long for even 64 of them."""
    if min(M, K, H, N) <= 0:
        raise ValueError(f"w8a8 MLP plan: M={M}, K={K}, H={H}, N={N}")
    tile, stages1, max_stages2, stage_ld, static, tile2 = _MLP_LAYOUT
    kp, hp = _round_up(K, 128), _round_up(H, 128)
    fits = []
    for rows in _MLP_ROWS:
        codes = rows * kp + stages1 * tile
        stage2 = tile2 + rows * 128
        stages2 = max(2, min(max_stages2, codes // stage2))
        smem = 1024 + max(codes, stages2 * stage2) + rows * stage_ld + 16 * rows
        if smem + static <= smem_limit:
            fits.append((rows, stages2, smem))
    if not fits:
        raise ValueError(f"w8a8 MLP: rows of K={K} do not fit the kernel's "
                         f"shared-memory code tile ({smem_limit} bytes a "
                         f"block)")
    full = [f for f in fits if -(-M // f[0]) >= sm_count]
    rows, stages2, smem = full[0] if full else fits[-1]
    grid = -(-M // rows)
    return {"rows": rows, "grid": grid, "stages2": stages2,
            "smem_bytes": smem, "scratch": (grid * rows, hp)}


def w8a8_qkv_plan(M: int, K: int, N: int, sm_count: int,
                  smem_limit: int) -> Dict:
    """Launch plan of the fused LN + q/k/v kernel on a card of `sm_count`
    SMs whose blocks may have `smem_limit` shared bytes: {'rows' (per block,
    the wgmma N), 'units' (128-column slabs of one output per block),
    'grid' (row tiles, unit groups), 'blocks', 'per_sm' (blocks an SM holds
    at once), 'stages' (of each weight ring), 'smem_bytes'}. A block keeps
    its rows' K codes in shared memory; the rest of it goes to the weight
    rings, as deep as it allows (up to 8 stages), and a tile of at most 64
    rows keeps two blocks on an SM where two fit with 3 stages each. The
    rows: 128 where those tiles alone give every SM a block (the serving
    shape), else 64, else 32 (measured fastest in that order on an H100,
    utils/kernel_variants.py); the 3 * ceil(N / 128) units are then shared
    out over the fewest groups that give every SM a block (the text tower's
    1,155 rows: 37 tiles of 32 x 4 groups). Raises for rows too long for
    even 32 of them with 3 stages."""
    if min(M, K, N) <= 0:
        raise ValueError(f"w8a8 q/k/v plan: M={M}, K={K}, N={N}")
    slab, max_stages, unit_cols, static = _QKV_LAYOUT
    kp = _round_up(K, 128)

    def smem(rows, stages):
        return 1024 + rows * kp + 2 * stages * slab + 4 * rows

    def form(rows):
        """(stages, blocks per SM) of a tile of `rows`, or None."""
        for per_sm in ((2, 1) if rows <= 64 else (1,)):
            room = min(smem_limit, _SM90_SMEM_PER_SM // per_sm
                       - _BLOCK_RESERVED_SMEM) - static
            stages = min(max_stages,
                         (room - smem(rows, 0)) // (2 * slab))
            if stages >= _QKV_MIN_STAGES:
                return stages, per_sm
        return None

    fits = {r: form(r) for r in _QKV_ROWS if form(r)}
    if not fits:
        raise ValueError(f"w8a8 q/k/v: rows of K={K} do not fit the "
                         f"kernel's shared-memory code tile ({smem_limit} "
                         f"bytes a block)")
    rows = next((r for r in fits if -(-M // r) >= sm_count), min(fits))
    stages, per_sm = fits[rows]
    tiles = -(-M // rows)
    total = 3 * -(-N // unit_cols)
    splits = [d for d in range(1, total + 1) if total % d == 0]
    split = next((d for d in splits if tiles * d >= sm_count), total)
    return {"rows": rows, "units": total // split, "grid": (tiles, split),
            "blocks": tiles * split, "per_sm": per_sm, "stages": stages,
            "smem_bytes": smem(rows, stages)}


def w8a8_matmul_plan(M: int, K: int, N: int, sm_count: int,
                     smem_limit: int, rows: Optional[int] = None,
                     units: Optional[int] = None, esize: int = 2) -> Dict:
    """Launch plan of the w8a8 GEMM on a card of `sm_count` SMs whose blocks
    may have `smem_limit` shared bytes: {'rows' (per block, the wgmma N),
    'units' (128-column slabs of W^T per block), 'grid' (row tiles, unit
    groups), 'blocks', 'per_sm' (blocks an SM holds at once), 'stages' (of
    each weight ring), 'smem_bytes'}. A block keeps its rows' K codes in
    shared memory; the rest goes to the weight rings, as deep as it allows
    (up to 8 stages), and a tile of at most 64 rows keeps two blocks on an SM
    where two fit with 3 stages each. The rows, in the order measured
    fastest on an H100: 192 where those tiles alone give every SM but at
    most one a block (the patch embed at batch 16: 131 tiles), else 32 (or
    the most that fit below it); the ceil(N / 128) units are then shared out
    over the most groups whose blocks still run in one wave (the text
    tower's 1,155 rows: 37 tiles of 32 x 4 groups, two blocks to an SM, at
    K = 512; x 2 groups, one block to an SM, at K = 2,048). `rows`
    and `units` take a form other than the plan's (utils/kernel_variants.py
    times them). `esize`: bytes of an element of x and y, 2 (bf16) or 4
    (the fp32 form, `_B2_LAYOUT_F32`: no staging tiles). Raises for rows
    too long for even 8 of them, or for a `rows` that does not fit."""
    if min(M, K, N) <= 0:
        raise ValueError(f"w8a8 GEMM plan: M={M}, K={K}, N={N}")
    if esize not in (2, 4):
        raise ValueError(f"w8a8 GEMM plan: elements of {esize} bytes")
    slab, max_stages, unit_cols, stage_bytes, static = \
        _B2_LAYOUT if esize == 2 else _B2_LAYOUT_F32
    kp = _round_up(K, 128)

    def smem(rows, stages):
        return 1024 + rows * kp + 2 * stages * slab + stage_bytes + 4 * rows

    def form(rows):
        """(stages, blocks per SM) of a tile of `rows`, or None."""
        for per_sm in ((2, 1) if rows <= 64 else (1,)):
            room = min(smem_limit, _SM90_SMEM_PER_SM // per_sm
                       - _BLOCK_RESERVED_SMEM) - static
            stages = min(max_stages, (room - smem(rows, 0)) // (2 * slab))
            if stages >= _QKV_MIN_STAGES:
                return stages, per_sm
        return None

    fits = {r: form(r) for r in _B2_ROWS if form(r)}
    if not fits:
        raise ValueError(f"w8a8 GEMM: rows of K={K} do not fit the kernel's "
                         f"shared-memory code tile ({smem_limit} bytes a "
                         f"block)")
    small = max(r for r in fits if r <= _B2_SMALL_ROWS)
    enough = sm_count - 1   # blocks: every SM but at most one has one
    if rows is None:
        wide = _B2_WIDE_ROWS in fits and -(-M // _B2_WIDE_ROWS) >= enough
        rows = _B2_WIDE_ROWS if wide else small
    elif rows not in fits:
        raise ValueError(f"w8a8 GEMM: {rows} rows of K={K} do not fit")
    stages, per_sm = fits[rows]
    tiles = -(-M // rows)
    total = -(-N // unit_cols)
    if units is None:
        splits = [d for d in range(1, total + 1) if total % d == 0
                  and tiles * d <= per_sm * sm_count]
        units = total // max(splits, default=1)
    split = -(-total // units)
    return {"rows": rows, "units": units, "grid": (tiles, split),
            "blocks": tiles * split, "per_sm": per_sm, "stages": stages,
            "smem_bytes": smem(rows, stages)}


def check_layout(lib, fn: str, want: Tuple[int, ...]) -> int:
    """Raise unless the constants that the built library's `fn` reports
    are `want`, those of the launch plan; return the shared bytes per block
    that it reports after them (the current device's opt-in limit)."""
    import ctypes
    out = (ctypes.c_int * (len(want) + 1))()
    getattr(lib, fn)(out)
    if tuple(out)[:len(want)] != tuple(want):
        raise RuntimeError(f"{fn}: the kernel's layout "
                           f"{tuple(out)[:len(want)]} is not the launch "
                           f"plan's {tuple(want)}")
    return out[len(want)]


def smem_limit(lib, fn: str, want: Tuple[int, ...], device) -> int:
    """`check_layout` on `device`, once per library, layout and device,
    before the wrapper's first launch there."""
    key = (getattr(lib, "_name", id(lib)), fn,
           torch.cuda.current_device() if device.index is None
           else device.index)
    if key not in _layout_checked:
        with torch.cuda.device(device):
            _layout_checked[key] = check_layout(lib, fn, want)
    return _layout_checked[key]


def _tma_rows(w: torch.Tensor) -> torch.Tensor:
    """The int8 W^T as TMA loads it: 16-byte aligned rows of a multiple of
    16 bytes, zero-padded (a copy) where they are not."""
    n, k = w.shape
    if k % 16 == 0 and w.data_ptr() % 16 == 0:
        return w
    out = w.new_zeros((n, _round_up(k, 16)))
    out[:, :k] = w
    return out


def _w8a8_mlp_launch(name, x, fc1, fc2, ln, residual):
    """Launch csrc/w8a8_mlp.cu (bf16) or w8a8_mlp_f32.cu (fp32): the
    residual form (ln and residual given) or the residual-free entry point
    (residual None, ln optional); rows and residual bf16 or fp32, counted
    under `name` (its `_f32` count in fp32)."""
    k1, k2 = fc1["kernel"], fc2["kernel"]
    form = _rows_dtype(name, x, residual)
    _check_cuda(name, x.device,
                (x, residual, k1.get("qa_t"), k1["scale"], fc1["bias"],
                 k2.get("qa_t"), k2["scale"], fc2["bias"], *(ln or ())))
    x = x.contiguous()
    M, K = x.shape
    w1 = _kernel_weight(f"{name} fc1", k1, K)
    H = w1.shape[0]
    w2 = _kernel_weight(f"{name} fc2", k2, H)
    N = w2.shape[0]
    if residual is not None and residual.shape != (M, N):
        raise ValueError(f"residual {tuple(residual.shape)}, expected "
                         f"({M}, {N})")
    r = None if residual is None else residual.contiguous()
    s1, b1 = _f32_vec(k1["scale"], H, "scale"), _f32_vec(fc1["bias"], H,
                                                         "bias")
    s2, b2 = _f32_vec(k2["scale"], N, "scale"), _f32_vec(fc2["bias"], N,
                                                         "bias")
    g, beta = (None, None) if ln is None else \
        (_f32_vec(p, K, "LayerNorm") for p in ln)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M:
        from ._cuda import load_library
        lib = "w8a8_mlp" if form == "bf16" else "w8a8_mlp_f32"
        plan = w8a8_mlp_plan(
            M, K, H, N,
            torch.cuda.get_device_properties(x.device).multi_processor_count,
            smem_limit(load_library(lib), "w8a8_mlp_layout", _MLP_LAYOUT,
                       x.device))
        w1, w2 = _tma_rows(w1), _tma_rows(w2)
        hq = torch.empty(plan["scratch"], dtype=torch.int8, device=x.device)
        head = (x.data_ptr(), w1.data_ptr(), s1.data_ptr(), b1.data_ptr(),
                w2.data_ptr(), s2.data_ptr(), b2.data_ptr(), _ptr(g),
                _ptr(beta))
        tail = (hq.data_ptr(), M, K, H, N, plan["rows"], plan["stages2"],
                plan["smem_bytes"])
        if residual is None:
            _launch(lib, f"w8a8_mlp_{form}", x.device, *head,
                    out.data_ptr(), *tail)
        else:
            _launch(lib, f"w8a8_mlp_res_{form}", x.device, *head,
                    r.data_ptr(), out.data_ptr(), *tail)
        launch_counts[_counted(name, form)] += 1
    return out


def w8a8_mlp_res_cuda(x, fc1, fc2, ln, residual):
    """Launch csrc/w8a8_mlp.cu (bf16) or w8a8_mlp_f32.cu (fp32): x,
    residual (M, K) -> (M, N) in their dtype."""
    return _w8a8_mlp_launch("w8a8_mlp_res", x, fc1, fc2, ln, residual)


def w8a8_mlp_cuda(x, fc1, fc2, ln=None):
    """Launch the residual-free entry point of csrc/w8a8_mlp.cu (bf16) or
    w8a8_mlp_f32.cu (fp32): x (M, K) -> (M, N) in x's dtype; ln None skips
    the LayerNorm."""
    return _w8a8_mlp_launch("w8a8_mlp", x, fc1, fc2, ln, None)


def int8_matmul_cuda(x, kernel):
    """Launch csrc/w8_matmul.cu (bf16 x) or csrc/w8_matmul_f32.cu (fp32 x):
    x (M, K) x kernel leaf {'q_t': the w8 kernel layout of the int8
    weight, 'scale': fp32 (1, N)} -> (M, N) in x's dtype, counted under
    `int8_matmul` or `int8_matmul_f32`; other dtypes raise TypeError (the
    w8a8 wrappers' rule, `_rows_dtype`). Both kernels load x in 16-byte
    rows at 16-byte aligned addresses (TMA in bf16, float4 in fp32): other
    rows are copied first, zero-padded to a multiple of 8 bf16 or 4 fp32
    values (the padding multiplies zero weights)."""
    form = _rows_dtype("int8_matmul", x)
    _check_cuda("int8_matmul", x.device, (x, kernel.get("q_t"),
                                          kernel["scale"]))
    x = x.contiguous()
    M, K = x.shape
    N = kernel["scale"].numel()
    wt = _kernel_weight("int8_matmul", kernel, K, N, key="q_t")
    s = _f32_vec(kernel["scale"], N, "scale")
    per_row = 16 // x.element_size()
    if K % per_row or x.data_ptr() % 16:
        padded = x.new_zeros((M, K + -K % per_row))
        padded[:, :K] = x
        x = padded
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M and N:
        lib = "w8_matmul" if form == "bf16" else "w8_matmul_f32"
        _launch(lib, f"w8_matmul_{form}", x.device, x.data_ptr(),
                wt.data_ptr(), s.data_ptr(), out.data_ptr(), M, x.shape[1],
                N)
        launch_counts[_counted("int8_matmul", form)] += 1
    return out


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _use_kernel(x: torch.Tensor, impl: str) -> bool:
    if impl == "plain" or x.device.type == "cpu":
        return False
    if impl != "kernel":
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    if x.device.type != "cuda":
        raise ValueError(f"no w8a8 kernel for device {x.device}")
    return True


def w8a8_matmul(x, kernel, bias=None, impl: str = "kernel"):
    """(M, K) x kernel leaf {'qa': int8 (K, N), 'scale': (1, N)}, bias (N,)
    -> (M, N) in x.dtype."""
    fn = w8a8_matmul_cuda if _use_kernel(x, impl) else w8a8_matmul_plain
    return fn(x, kernel, bias)


def w8a8_matmul3_cat(x, e, kernels3: Sequence, bias3: Sequence,
                     ln: Sequence, impl: str = "kernel"):
    """LN + shared quant + q/k/v int8 GEMMs (three kernel leaves) over the
    per-clip rows [x (B, Lx, K); e (B, Le, K)] (e may be None: Le = 0)."""
    fn = w8a8_matmul3_cat_cuda if _use_kernel(x, impl) \
        else w8a8_matmul3_cat_plain
    return fn(x, e, tuple(kernels3), tuple(bias3), tuple(ln))


def w8a8_matmul3(x, kernels3: Sequence, bias3: Sequence,
                 ln: Optional[Sequence] = None, impl: str = "kernel"):
    """[LN +] one shared quant + q/k/v int8 GEMMs (three kernel leaves)
    over (M, K) rows -> three (M, N) in x.dtype (JAX `w8a8_matmul3`); ln is
    (scale, bias) or None."""
    fn = w8a8_matmul3_cuda if _use_kernel(x, impl) else w8a8_matmul3_plain
    return fn(x, tuple(kernels3), tuple(bias3),
              None if ln is None else tuple(ln))


def w8a8_mlp_res(x, fc1, fc2, ln, residual, impl: str = "kernel"):
    """residual + fc2(QuickGELU(fc1(LN(x)))), all w8a8, over (M, K) rows."""
    fn = w8a8_mlp_res_cuda if _use_kernel(x, impl) else w8a8_mlp_res_plain
    return fn(x, fc1, fc2, tuple(ln), residual)


def w8a8_mlp(x, fc1, fc2, ln=None, impl: str = "kernel"):
    """fc2(QuickGELU(fc1([LN](x)))), all w8a8, over (M, K) rows, with no
    residual (JAX `w8a8_mlp`); ln is (scale, bias) or None."""
    fn = w8a8_mlp_cuda if _use_kernel(x, impl) else w8a8_mlp_plain
    return fn(x, fc1, fc2, None if ln is None else tuple(ln))


def int8_matmul(x, kernel, impl: str = "kernel"):
    """x (M, K) @ dequant(kernel leaf {'q': int8 (K, N), 'scale': (1, N)})
    -> (M, N) in x.dtype (JAX `int8_matmul`)."""
    if _use_kernel(x, impl):
        return int8_matmul_cuda(x, kernel)
    return int8_matmul_plain(x, kernel["q"], kernel["scale"])


def quantized_linear(params, x, impl: str = "kernel"):
    """A linear layer whose kernel is a weight-only int8 leaf {'q', 'scale'}
    (JAX `quantized_linear`): the w8 GEMM over the flattened rows, then the
    bias added in the output dtype."""
    kernel = params["kernel"]
    y = int8_matmul(x.reshape(-1, x.shape[-1]), kernel, impl=impl)
    y = y.reshape(*x.shape[:-1], y.shape[-1])
    bias = params.get("bias")
    return y if bias is None else y + bias.to(y.dtype)


# ---------------------------------------------------------------------------
# int8 training of frozen weights (`--int8_frozen`): the generic w8a8
# helpers of the JAX package and its three straight-through ops
# ---------------------------------------------------------------------------

def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization (JAX `quantize_act`): int8 codes
    and the fp32 row scale xs (..., 1). Unlike the kernels' `quant_rows` it
    divides by xs (a tensor by a tensor, one IEEE rounding) and clips to
    +-127, so a code can differ from theirs by one at a rounding tie."""
    xf = x.float()
    xs = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-6) * \
        _INV127
    return torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8), xs


def int8_apply(qleaf, xq: torch.Tensor, xs: torch.Tensor, bias=None,
               out_dtype=None) -> torch.Tensor:
    """The int8 product of codes xq (..., K) and the leaf's 'qa' (K, N),
    rescaled by xs and the channel scales [+ bias] in fp32, cast to
    out_dtype (xs's dtype by default) (JAX `int8_apply`)."""
    q = qleaf["qa"]
    acc = int_matmul(xq.reshape(-1, xq.shape[-1]), q)
    y = rescale(acc, xs.reshape(-1, 1), qleaf["scale"], bias)
    return y.reshape(*xq.shape[:-1], q.shape[-1]).to(out_dtype or xs.dtype)


def int8_dynamic_linear(params, x: torch.Tensor,
                        impl: str = "kernel") -> torch.Tensor:
    """A whole w8a8 linear over a 'qa' leaf (JAX `int8_dynamic_linear`):
    the B2 kernel on the card, else the composition `quantize_act` +
    `int8_apply` with the bias added in the output dtype, as the JAX
    function runs where its kernels are not active."""
    kernel, bias = params["kernel"], params.get("bias")
    x2 = x.reshape(-1, x.shape[-1])
    if _use_kernel(x2, impl):
        y = w8a8_matmul_cuda(x2, kernel, bias)
    else:
        y = int8_apply(kernel, *quantize_act(x2), out_dtype=x.dtype)
        if bias is not None:
            y = y + bias.to(y.dtype)
    return y.reshape(*x.shape[:-1], y.shape[-1])


# The straight-through ops run frozen projections (the CLIP backbone) with
# an int8 forward through the w8a8 ops (B2, B3a, B5, or their plain versions)
# and a backward that computes dx alone, by the JAX package's formulas: the
# weight dequantized in the cotangent's dtype, the quantization passed
# straight through, no gradient for the int8 weights, scales, biases or
# LayerNorm parameters (frozen). The backward never reads the forward's
# output, so the kernel path and the plain path give the same dx.

def _as_w8a8_leaf(kernel) -> Dict:
    """A frozen-training leaf {'qt', 'scale'[, 'qt_t']} as the w8a8 ops'
    leaf {'qa', 'scale'[, 'qa_t']}."""
    out = {"qa": kernel["qt"], "scale": kernel["scale"]}
    if "qt_t" in kernel:
        out["qa_t"] = kernel["qt_t"]
    return out


def _dequant_as(kernel, dtype) -> torch.Tensor:
    """The (K, N) weight of a w8a8 leaf in `dtype`, as JAX's
    straight-through backwards dequantize it."""
    return dequantize_weight(kernel["qa"], kernel["scale"], dtype)


def _ln_stats(x32: torch.Tensor, eps: float = _LN_EPS):
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (x32 - mean) * inv, inv


def _ln_bwd_input(g_n, xhat, inv, gamma):
    """dx of y = gamma * xhat + beta with respect to x, gamma and beta
    constant."""
    g = g_n * gamma
    return inv * (g - g.mean(dim=-1, keepdim=True)
                  - xhat * (g * xhat).mean(dim=-1, keepdim=True))


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of the fp32 values of a and b (JAX `a32 @ b.astype(f32)`).
    bf16 operands on the card take the bf16 tensor-core product with fp32
    accumulation and an fp32 output: each product of two bf16 values is
    exact in fp32, so only the order of the fp32 sums differs from the
    fp32 product, at the bf16 rate instead of the fp32 one."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _quick_gelu_grad(h: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(1.702 * h)
    return s + h * 1.702 * s * (1.0 - s)


class _Int8LinearST(torch.autograd.Function):
    """JAX `int8_linear_st`: saves no activation."""

    @staticmethod
    def forward(ctx, x, kernel, bias, impl):
        ctx.kernel = kernel
        y = w8a8_matmul(x.reshape(-1, x.shape[-1]), kernel, bias, impl=impl)
        return y.reshape(*x.shape[:-1], y.shape[-1])

    @staticmethod
    def backward(ctx, g):
        w = _dequant_as(ctx.kernel, g.dtype)
        dx = g.reshape(-1, g.shape[-1]) @ w.t()
        return dx.reshape(*g.shape[:-1], w.shape[0]), None, None, None


class _Int8QKV3ST(torch.autograd.Function):
    """JAX `int8_qkv3_st`: saves the input rows."""

    @staticmethod
    def forward(ctx, x, kernels3, bias3, ln, impl):
        ctx.save_for_backward(x)
        ctx.kernels3, ctx.gamma = kernels3, ln[0]
        return w8a8_matmul3(x, kernels3, bias3, ln, impl=impl)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        x, = ctx.saved_tensors
        dn = None
        for gi, kernel in zip((gq, gk, gv), ctx.kernels3):
            d = gi @ _dequant_as(kernel, gi.dtype).t()
            dn = d if dn is None else dn + d
        xhat, inv = _ln_stats(x.float())
        dx = _ln_bwd_input(dn.float(), xhat, inv, ctx.gamma.float())
        return dx.to(x.dtype), None, None, None, None


class _Int8MlpST(torch.autograd.Function):
    """JAX `int8_mlp_st`: saves the input rows; the backward recomputes LN2
    and fc1 in the cotangent's dtype."""

    @staticmethod
    def forward(ctx, x, fc1, fc2, ln, residual, impl):
        ctx.save_for_backward(x)
        ctx.fc1, ctx.fc2, ctx.ln = fc1, fc2, ln
        return w8a8_mlp_res(x, fc1, fc2, ln, residual, impl=impl)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        xhat, inv = _ln_stats(x.float())
        gamma = ctx.ln[0].float()
        n = (xhat * gamma + ctx.ln[1].float()).to(g.dtype)
        w1 = _dequant_as(ctx.fc1["kernel"], g.dtype)
        w2 = _dequant_as(ctx.fc2["kernel"], g.dtype)
        h = (n @ w1).float() + ctx.fc1["bias"].float()
        da = _f32_product(g, w2.t())
        dh = (da * _quick_gelu_grad(h)).to(g.dtype)
        dx = _ln_bwd_input((dh @ w1.t()).float(), xhat, inv, gamma)
        return dx.to(x.dtype), None, None, None, g, None


def int8_linear_st(x: torch.Tensor, kernel, bias=None,
                   impl: str = "kernel") -> torch.Tensor:
    """x (..., K) through a frozen int8 linear: B2 (`w8a8_matmul`) forward,
    dx = g @ dequant(W)^T backward (JAX `int8_linear_st`). kernel: a 'qt'
    leaf."""
    return _Int8LinearST.apply(x, _as_w8a8_leaf(kernel), bias, impl)


def int8_qkv3_st(x: torch.Tensor, kernels3: Sequence, bias3: Sequence,
                 ln: Sequence, impl: str = "kernel"):
    """LN1 + one shared quant + the q/k/v int8 GEMMs over (M, K) rows, B3a
    (`w8a8_matmul3`) forward; backward dx = the LayerNorm input formula on
    sum_i g_i @ dequant(W_i)^T (JAX `int8_qkv3_st`). kernels3: three 'qt'
    leaves; ln: (scale, bias)."""
    return _Int8QKV3ST.apply(x, tuple(_as_w8a8_leaf(k) for k in kernels3),
                             tuple(bias3), tuple(ln), impl)


def int8_mlp_st(x: torch.Tensor, fc1, fc2, ln: Sequence,
                residual: torch.Tensor, impl: str = "kernel"):
    """residual + fc2(QuickGELU(fc1(LN2(x)))) over (M, K) rows, B5
    (`w8a8_mlp_res`) forward; backward dx through LN2, fc1 recomputed and
    QuickGELU's derivative, and the residual's cotangent g (JAX
    `int8_mlp_st`). fc1 / fc2: {'kernel': 'qt' leaf, 'bias'}."""
    fc1, fc2 = ({"kernel": _as_w8a8_leaf(fc["kernel"]), "bias": fc["bias"]}
                for fc in (fc1, fc2))
    return _Int8MlpST.apply(x, fc1, fc2, tuple(ln), residual, impl)
