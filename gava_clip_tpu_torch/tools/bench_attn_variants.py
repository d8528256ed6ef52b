"""Two forms of one w8a8 ViT layer at the bench shape (port of
tools/bench_attn_variants.py of the JAX package):

  base  the serving composition: w8a8_matmul3 (LN + one shared quant + the
        q/k/v products, csrc/w8a8_qkv.cu) -> flash_attention_out_int8
        (attention + int8 out-projection + residual,
        csrc/attention_out_int8.cu) -> w8a8_mlp_res (LN + int8 MLP +
        residual, csrc/w8a8_mlp.cu);
  mega  ONE launch per layer (csrc/mega_layer.cu, TPU `_mega_kernel`): LN1
        + quant + int8 q/k/v + per-head attention + int8 out-projection +
        residual + LN2 + int8 MLP (QuickGELU) + residual, for every frame
        row.

    python -m gava_clip_tpu_torch.tools.bench_attn_variants --parity   # on the card
    python -m gava_clip_tpu_torch.tools.bench_attn_variants --iters 30
    python -m gava_clip_tpu_torch.tools.bench_attn_variants --parity --device cpu --frames 2

`--parity` holds mega against base (largest |difference| over the largest
|base|, below 2e-2); timing prints both in ms per layer by CUDA events (a
card only). On the CPU both run their plain versions.

The mega layer's semantics are those of the TPU kernel, not of the
serving composition:
  * the LN1 rows are [x; e], quantized per row once; q is made from the x
    rows only, k and v from all of them;
  * q, k and v are rounded to bf16 before the score product; the softmax is
    the exact one (scores times head_dim^-0.5, the row's max subtracted,
    exp, divided by the row's sum); the probabilities are rounded to bf16
    before the product with v;
  * the attention output stays fp32 into its per-row quant, and the
    residual stays fp32 through the out-projection, LN2 and the MLP: only
    the layer's output is cast to x's dtype. (base rounds the residual to
    bf16 after the attention; that is most of mega's distance from it.)
  * a residual is added before the bias, as the TPU kernel writes it:
    (r + (acc * xs) * s) + b.
"""

import argparse
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.flash_attention import flash_attention_out_int8
from ..ops.int8_matmul import (_use_kernel, int_matmul, ln_f32,
                               quant_rows, quick_gelu_f32, rescale,
                               w8a8_matmul3, w8a8_mlp_res,
                               with_kernel_layout)
from ..utils.device import resolve_device

# the JAX tool's shape: 8 clips x 8 frames, 197 tokens + 17 extras rows
# (8 global + 1 summary + 8 local prompts), ViT-B/16 widths
B, T, Lx, Lext, D, H, HEADS = 8, 8, 197, 17, 768, 3072, 12
Lkv = Lx + Lext
# the tool's parity gate: max |mega - base| / max |base|
PARITY_REL = 2e-2

# launches of the hand-written kernel since the last reset
launch_counts = {"mega_layer": 0}


def reset_launch_counts() -> None:
    launch_counts["mega_layer"] = 0


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def make_params(rs: np.random.RandomState, d: int = D, h: int = H):
    """The JAX tool's parameters, drawn from `rs` in its order, as numpy
    in its tree: attn_p {q, k, v, out}, mlp_p {fc1, fc2} of
    {"kernel": {"qa" int8 (K, N), "scale" fp32 (1, N)}, "bias" fp32 (N,)},
    ln1, ln2 (scale, bias) fp32. Weight scales make the dequantized weights
    ~N(0, 1/sqrt(fan_in)); the scores stay far from any clamp."""
    def qleaf(k, n):
        qa = rs.randint(-127, 128, (k, n), np.int8)
        scale = (np.abs(rs.randn(1, n)).astype(np.float32)
                 * (0.5 / 127.0 / np.sqrt(k))).astype(np.float32)
        bias = rs.randn(n).astype(np.float32) * 0.01
        return {"kernel": {"qa": qa, "scale": scale}, "bias": bias}
    attn_p = {n: qleaf(d, d) for n in ("q", "k", "v", "out")}
    mlp_p = {"fc1": qleaf(d, h), "fc2": qleaf(h, d)}
    ln1 = (1 + 0.01 * rs.randn(d).astype(np.float32),
           0.01 * rs.randn(d).astype(np.float32))
    ln2 = (1 + 0.01 * rs.randn(d).astype(np.float32),
           0.01 * rs.randn(d).astype(np.float32))
    return attn_p, mlp_p, ln1, ln2


def make_inputs(rs: np.random.RandomState, frames: int = B * T,
                lx: int = Lx, le: int = Lext, d: int = D, device="cpu"):
    """x (frames, lx, d) and extras (frames, le, d) bf16, drawn after the
    parameters as the JAX tool's main draws them."""
    x = rs.randn(frames, lx, d).astype(np.float32) * 0.1
    e = rs.randn(frames, le, d).astype(np.float32) * 0.1
    return (torch.from_numpy(x).to(device=device, dtype=torch.bfloat16),
            torch.from_numpy(e).to(device=device, dtype=torch.bfloat16))


def params_to_port(attn_p, mlp_p, ln1, ln2, device="cpu"):
    """The JAX-shaped numpy tree as the port's leaves on `device`: torch
    tensors, each kernel leaf with the W^T copy ('qa_t') the CUDA kernels
    read (ops.int8_matmul.with_kernel_layout)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return torch.from_numpy(np.asarray(t)).to(device)
    return (with_kernel_layout(conv(attn_p)), with_kernel_layout(conv(mlp_p)),
            tuple(conv(p) for p in ln1), tuple(conv(p) for p in ln2))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _residual(r32, codes, xs, leaf):
    """(r + (acc * xs) * s) + b: the TPU kernel's order of the residual and
    the bias."""
    acc = int_matmul(codes, leaf["kernel"]["qa"])
    return (r32 + acc * xs * leaf["kernel"]["scale"].float().reshape(-1)) \
        + leaf["bias"].float()


def _attention_exact(q, k, v, heads: int):
    """Per-head attention of fp32 q (F, Lq, D) over k, v (F, Lk, D): q, k, v
    rounded to bf16, scores times head_dim^-0.5 in fp32, the exact softmax
    (max subtracted, exp, divided by the sum), the probabilities rounded
    to bf16, fp32 products -> (F, Lq, D) fp32."""
    F_, Lq, D_ = q.shape
    dh = D_ // heads

    def split(t):
        return t.to(torch.bfloat16).float().reshape(
            F_, t.shape[1], heads, dh).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    scores = (qh @ kh.transpose(-1, -2)) * (dh ** -0.5)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    out = probs.to(torch.bfloat16).float() @ vh
    return out.transpose(1, 2).reshape(F_, Lq, D_)


def mega_layer_f32(x, extras, attn_p, mlp_p, ln1, ln2, heads=HEADS
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version's output in fp32, before its one rounding, and the
    hidden's row scales (F, Lx, 1): a code flip of the hidden's quant moves
    an output by xs_hidden * s2 * 127, the unit the checks count in."""
    lx = x.shape[1]
    x32 = x.float()
    kvq, kvs = quant_rows(ln_f32(torch.cat([x32, extras.float()], dim=1),
                                 *ln1))

    def proj(name, codes, xs):
        leaf = attn_p[name]
        return rescale(int_matmul(codes, leaf["kernel"]["qa"]), xs,
                       leaf["kernel"]["scale"], leaf["bias"])

    q = proj("q", kvq[:, :lx], kvs[:, :lx])
    k, v = proj("k", kvq, kvs), proj("v", kvq, kvs)
    aq, axs = quant_rows(_attention_exact(q, k, v, heads))
    x1 = _residual(x32, aq, axs, attn_p["out"])
    hq, hs = quant_rows(ln_f32(x1, *ln2))
    fc1 = mlp_p["fc1"]
    hmid = quick_gelu_f32(rescale(int_matmul(hq, fc1["kernel"]["qa"]), hs,
                                  fc1["kernel"]["scale"], fc1["bias"]))
    mq, ms = quant_rows(hmid)
    return _residual(x1, mq, ms, mlp_p["fc2"]), ms


def mega_layer_plain(x, extras, attn_p, mlp_p, ln1, ln2, heads=HEADS):
    """Plain version of csrc/mega_layer.cu: x (F, Lx, D), extras (F, Le, D)
    -> (F, Lx, D) in x's dtype."""
    return mega_layer_f32(x, extras, attn_p, mlp_p, ln1, ln2,
                          heads)[0].to(x.dtype)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

# the kernel's limits (csrc/mega_layer.cu): head dim, most keys of a frame
# row (two tiles of 128; a whole score row is held per head), most values of
# a quantized row in registers, rows of a tile
_HEAD_DIM, _MAX_KEYS, _MAX_ROW, _TILE = 64, 256, 1024, 128


def mega_layer_plan(frames: int, sm_count: int, lx: int = Lx,
                    le: int = Lext) -> Dict:
    """Launch plan of csrc/mega_layer.cu: {'split': CTAs per frame row (one
    thread-block cluster), 'grid': (split, frames), 'tiles': the frame
    row's kv and query tiles of up to 128 rows, (ceil((lx + le) / 128),
    ceil(lx / 128))}. CTA r of a cluster takes the tiles r, r + split, ..
    of each kind; one CTA fits an SM. A frame row takes as many CTAs as it
    has tiles (2 at the tool's shape) where every CTA of the grid then has
    an SM of its own, else one."""
    if frames <= 0 or sm_count <= 0 or lx <= 0 or le < 0:
        raise ValueError(f"mega layer plan: frames={frames}, "
                         f"sm_count={sm_count}, lx={lx}, le={le}")
    tiles = (-(-(lx + le) // _TILE), -(-lx // _TILE))
    split = max(tiles) if frames * max(tiles) <= sm_count else 1
    return {"split": split, "grid": (split, frames), "tiles": tiles}


def _check_shapes(x, extras, heads, d_hidden):
    F_, lx, d = x.shape
    if extras.dim() != 3 or extras.shape[0] != F_ or extras.shape[2] != d:
        raise ValueError(f"extras {tuple(extras.shape)} vs x "
                         f"{tuple(x.shape)}")
    if d != heads * _HEAD_DIM or d % 128 or d > _MAX_ROW:
        raise ValueError(f"mega layer kernel: width {d} must be heads x "
                         f"{_HEAD_DIM}, a multiple of 128 and at most "
                         f"{_MAX_ROW}")
    if d_hidden % 128:
        raise ValueError(f"mega layer kernel: hidden width {d_hidden} must "
                         f"be a multiple of 128")
    if not 1 <= lx + extras.shape[1] <= _MAX_KEYS or lx < 1:
        raise ValueError(f"mega layer kernel: {lx} + {extras.shape[1]} rows "
                         f"a frame row, at most {_MAX_KEYS} keys")


def mega_layer_cuda(x, extras, attn_p, mlp_p, ln1, ln2, heads=HEADS,
                    split: Optional[int] = None):
    """Launch csrc/mega_layer.cu on the current stream (no sync): x (F, Lx,
    D), extras (F, Le, D) bf16 -> (F, Lx, D) bf16. `split` overrides the
    plan's CTAs per frame row (the kernel refuses more than the frame row
    has tiles of a kind)."""
    from ..ops._cuda import load_library
    from ..ops.int8_matmul import _check_cuda, _f32_vec, _kernel_weight
    names = ("q", "k", "v", "out")
    leaves = [attn_p[n] for n in names] + [mlp_p["fc1"], mlp_p["fc2"]]
    _check_cuda("mega_layer", x.device,
                (x, extras, *(l["kernel"].get("qa_t") for l in leaves),
                 *(l["kernel"]["scale"] for l in leaves),
                 *(l["bias"] for l in leaves), *ln1, *ln2))
    if x.dtype != torch.bfloat16 or extras.dtype != torch.bfloat16:
        raise TypeError(f"mega layer kernel takes bfloat16 rows, got "
                        f"{x.dtype} / {extras.dtype}: the tool runs its "
                        f"layer in bf16, as the JAX tool does")
    F_, lx, d = x.shape
    le = extras.shape[1]
    wt = [_kernel_weight("mega_layer", attn_p[n]["kernel"], d, d)
          for n in names]
    w1 = _kernel_weight("mega_layer fc1", mlp_p["fc1"]["kernel"], d)
    hd = w1.shape[0]
    w2 = _kernel_weight("mega_layer fc2", mlp_p["fc2"]["kernel"], hd, d)
    _check_shapes(x, extras, heads, hd)
    x, extras = x.contiguous(), extras.contiguous()
    vec = [_f32_vec(attn_p[n]["kernel"]["scale"], d, "scale") for n in names]
    vec += [_f32_vec(attn_p[n]["bias"], d, "bias") for n in names]
    vec += [_f32_vec(mlp_p["fc1"]["kernel"]["scale"], hd, "scale"),
            _f32_vec(mlp_p["fc1"]["bias"], hd, "bias"),
            _f32_vec(mlp_p["fc2"]["kernel"]["scale"], d, "scale"),
            _f32_vec(mlp_p["fc2"]["bias"], d, "bias")]
    vec += [_f32_vec(p, d, "LayerNorm") for p in (*ln1, *ln2)]
    out = torch.empty_like(x)
    if F_ == 0:
        return out
    lib = load_library("mega_layer")
    if split is None:
        split = mega_layer_plan(F_, torch.cuda.get_device_properties(
            x.device).multi_processor_count, lx, le)["split"]
    work = torch.empty(lib.mega_layer_workspace(F_, lx, le, d, hd),
                       dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.mega_layer_bf16(
            x.data_ptr(), extras.data_ptr(), *(w.data_ptr() for w in wt),
            w1.data_ptr(), w2.data_ptr(), *(v.data_ptr() for v in vec),
            out.data_ptr(), work.data_ptr(), F_, lx, le, d, hd, heads,
            split, stream)
    if err != 0:
        raise RuntimeError(f"mega_layer_bf16 kernel launch failed: "
                           f"{lib.cuda_error_string(err).decode()} ({err})")
    launch_counts["mega_layer"] += 1
    return out


def mega_layer(x, extras, attn_p, mlp_p, ln1, ln2, heads=HEADS,
               impl: str = "kernel"):
    """One w8a8 layer per frame row: x (F, Lx, D) tokens, extras (F, Le, D)
    extra key rows -> (F, Lx, D). impl 'kernel' runs the plain version on
    the CPU and the CUDA kernel on a card (or raises); 'plain' the plain
    version on any device."""
    fn = mega_layer_cuda if _use_kernel(x, impl) else mega_layer_plain
    return fn(x, extras, attn_p, mlp_p, ln1, ln2, heads)


def base_layer(x, extras, attn_p, mlp_p, ln1, ln2, heads=HEADS,
               impl: str = "kernel"):
    """The serving composition for the same math: B3a on the [x; e] rows,
    B4 on the x rows' queries, B5 with its residual."""
    F_, lx, d = x.shape
    kv = torch.cat([x, extras], dim=1)
    outs = w8a8_matmul3(
        kv.reshape(-1, d), [attn_p[n]["kernel"] for n in ("q", "k", "v")],
        [attn_p[n]["bias"] for n in ("q", "k", "v")], ln=ln1, impl=impl)
    qp, kp, vp = (o.reshape(kv.shape) for o in outs)
    x = flash_attention_out_int8(qp[:, :lx], kp, vp, heads, attn_p["out"],
                                 x, impl=impl)
    x2 = x.reshape(-1, d)
    return w8a8_mlp_res(x2, mlp_p["fc1"], mlp_p["fc2"], ln2, x2,
                        impl=impl).reshape(F_, lx, d)


# ---------------------------------------------------------------------------
# the tool
# ---------------------------------------------------------------------------

def parity(x, extras, attn_p, mlp_p, ln1, ln2, heads=HEADS):
    """(max |mega - base|, that over max |base|) through the kernels on a
    card, the plain versions on the CPU."""
    a = base_layer(x, extras, attn_p, mlp_p, ln1, ln2, heads).float()
    b = mega_layer(x, extras, attn_p, mlp_p, ln1, ln2, heads).float()
    diff = (a - b).abs().max().item()
    return diff, diff / max(a.abs().max().item(), 1e-6)


def _time_ms(fn, iters: int) -> float:
    """Best of 3 runs of `iters` calls, CUDA-event ms per call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parity", action="store_true")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the plain versions")
    ap.add_argument("--frames", type=int, default=B * T,
                    help="frame rows (the JAX tool's 64 by default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rs = np.random.RandomState(0)
    params = params_to_port(*make_params(rs), device=dev)
    x, extras = make_inputs(rs, args.frames, device=dev)

    if args.parity:
        diff, rel = parity(x, extras, *params)
        print(f"parity max abs diff {diff:.5f} (rel {rel:.5f})")
        if not rel < PARITY_REL:
            print("mega kernel diverges from base composition")
            return 1
        print("PARITY OK")
        return 0

    if dev.type != "cuda":
        print("timing runs on a CUDA device (CUDA events); on the CPU only "
              "--parity runs", file=sys.stderr)
        return 2
    for name, fn in (("base", base_layer), ("mega", mega_layer)):
        best = _time_ms(lambda: fn(x, extras, *params), args.iters)
        print(f"{name}: {best:.3f} ms/layer  (x12 = {best * 12:.1f} "
              f"ms/fwd-equiv; {args.frames} frame rows, "
              f"{torch.cuda.get_device_name(dev)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
