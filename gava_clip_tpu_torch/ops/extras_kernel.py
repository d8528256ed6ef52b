"""Fused prompt extras of the w8a8 serving path (port of
gava_clip_tpu/ops/extras_kernel.py).

Per vision block, the prompt machinery around the main attention (the
cls_proj GEMM, the summary LayerNorm, the Tb-token summary attention with
its four GEMMs, the local-prompt add and per-clip repeat, the global-prompt
repeat and the concatenation) is about ten small stock ops. `fused_extras`
computes the whole branch in ONE launch (csrc/fused_extras.cu) and emits the
extras rows (BT, le_pad, D) that feed `w8a8_matmul3_cat`, plus the per-frame
summary tokens.

All arithmetic is fp32 whatever the dtypes of the inputs (the stock branch
rounds to the activation dtype between its ops), the softmax is the exact
one (max subtracted, exp, divide), and both outputs are cast to cls's dtype
at the end. `fused_extras_plain` is the same math in plain PyTorch: a CPU
tensor runs it; a CUDA tensor launches the kernel or raises.

Switch: `set_fused_extras(True)`, or GAVA_FUSED_EXTRAS=1 in the environment;
off by default. `models/vision._block` reads it at every call.
"""

import contextlib
import math
import os
from typing import Dict, Tuple

import torch

from .int8_matmul import ln_f32

FUSED_EXTRAS = os.environ.get("GAVA_FUSED_EXTRAS", "0") == "1"

# launches of the hand-written kernel since the last reset
launch_counts = {"fused_extras": 0}


def reset_launch_counts() -> None:
    launch_counts["fused_extras"] = 0


def set_fused_extras(enabled: bool) -> None:
    """Route the serving extras branch through the fused op. Affects
    forwards made after the call."""
    global FUSED_EXTRAS
    FUSED_EXTRAS = bool(enabled)


def _check_shapes(cls, g_prompt, Tb: int, num_heads: int, le_pad: int):
    BT, D = cls.shape
    G = g_prompt.shape[0]
    if BT % Tb:
        raise ValueError(f"{BT} cls rows are no multiple of Tb = {Tb}")
    if D % num_heads:
        raise ValueError(f"width {D} not divisible by {num_heads} heads")
    if le_pad < G + 1 + Tb:
        raise ValueError(f"le_pad {le_pad} < G + 1 + Tb = {G + 1 + Tb}")
    return BT, D, G


def fused_extras_plain(cls: torch.Tensor, p, g_prompt: torch.Tensor, *,
                       Tb: int, num_heads: int, le_pad: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of csrc/fused_extras.cu, fp32 throughout."""
    BT, D, G = _check_shapes(cls, g_prompt, Tb, num_heads, le_pad)
    Bb, Dh = BT // Tb, D // num_heads
    a = p["summary_attn"]

    def lin(x, lp):
        return x @ lp["kernel"].float() + lp["bias"].float()

    def heads(x):
        return x.reshape(Bb, Tb, num_heads, Dh).transpose(1, 2)

    cp = lin(cls.float(), p["cls_proj"])                      # (BT, D)
    sn = ln_f32(cp, p["summary_ln"]["scale"], p["summary_ln"]["bias"])
    q, k, v = (heads(lin(sn, a[n])) for n in ("q", "k", "v"))
    s = (q @ k.transpose(-1, -2)) * Dh ** -0.5                # (Bb, H, Tb, Tb)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    attn = (e / e.sum(dim=-1, keepdim=True)) @ v
    summary = cp + lin(attn.transpose(1, 2).reshape(BT, D), a["out"])
    # clip b's Tb local rows, repeated for each of its Tb frame rows
    local = (p["local_prompts"].float().reshape(Tb, D)
             + cp.reshape(Bb, Tb, D))[:, None].expand(Bb, Tb, Tb, D)
    parts = [g_prompt.float()[None].expand(BT, G, D), summary[:, None],
             local.reshape(BT, Tb, D)]
    if le_pad > G + 1 + Tb:
        parts.append(cls.new_zeros((BT, le_pad - (G + 1 + Tb), D),
                                   dtype=torch.float32))
    return (torch.cat(parts, dim=1).to(cls.dtype),
            summary.to(cls.dtype).reshape(Bb, Tb, D))


def _f32(t: torch.Tensor, shape, what: str) -> torch.Tensor:
    """t's values as a contiguous fp32 tensor of `shape` (t itself when it
    is one already, in whatever shape: the kernel reads its pointer)."""
    if t.numel() != math.prod(shape):
        raise ValueError(f"{what}: {tuple(shape)} expected, got "
                         f"{tuple(t.shape)}")
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.reshape(shape).float().contiguous()


# Launch plan of csrc/fused_extras.cu: one persistent cooperative launch of
# clusters of `cs` blocks, a cluster per 64-column slice of cls_proj / the
# out-projection and per head (12 at ViT-B/16's width), every block
# resident at once (the kernel's stages meet at grid-wide barriers). The
# numbers are the source's layout (`fused_extras_layout`): rows of a row
# tile, K values of a sub-chunk, columns of a slice, q/k/v columns of a
# head, most frame rows of a clip, most blocks of a cluster, and the
# dynamic shared bytes with fp32 and with bf16 weights.
_EXTRAS_LAYOUT = (128, 96, 64, 192, 64, 8, 231424, 193024)
_EXTRAS_CS = 8
_layout_checked = set()
# (device index, cluster size, bf16 weights?) -> most resident clusters
_max_clusters = {}


def fused_extras_plan(Bb: int, Tb: int, D: int, num_heads: int,
                      max_clusters: int, cs: int = _EXTRAS_CS) -> Dict:
    """Clusters, blocks and workspace of one launch on a card that holds
    `max_clusters` clusters of `cs` blocks at once: {'cs', 'clusters',
    'blocks', 'k_per_block', 'sub_chunks', 'row_tiles',
    'workspace_floats'}. Raises ValueError for shapes the kernel does not
    take."""
    rows, kc, slice_n, head_n, max_tb, max_cs, _, _ = _EXTRAS_LAYOUT
    Dh = D // num_heads if num_heads else 0
    if D % 4 or not num_heads or D % num_heads or Dh % 4 or \
            Dh > head_n // 3:
        raise ValueError(f"fused_extras kernel: width {D} over {num_heads} "
                         f"heads (a head of a multiple of 4 values, at most "
                         f"{head_n // 3})")
    if not 1 <= Tb <= max_tb or Bb < 1:
        raise ValueError(f"fused_extras kernel: {Bb} clips of {Tb} frames "
                         f"(at most {max_tb} frames)")
    if cs not in (1, 2, 4, 8) or cs > max_cs:
        raise ValueError(f"fused_extras kernel: cluster of {cs} blocks")
    if max_clusters < 1:
        raise ValueError("fused_extras kernel: the card holds no cluster of "
                         f"{cs} blocks")
    ns = -(-D // slice_n)
    clusters = min(max(ns, num_heads), max_clusters)
    k_per_block = -(-D // (cs * 8)) * 8
    BT = Bb * Tb
    return {"cs": cs, "clusters": clusters, "blocks": cs * clusters,
            "k_per_block": k_per_block,
            "sub_chunks": -(-k_per_block // kc),
            "row_tiles": -(-BT // rows),
            "workspace_floats": (2 * BT * D + head_n * num_heads * BT
                                 + 2 * BT * ns)}


def _check_layout(lib) -> None:
    """Raise unless the built library's layout is the plan's."""
    if "fused_extras" in _layout_checked:
        return
    import ctypes
    out = (ctypes.c_int * len(_EXTRAS_LAYOUT))()
    lib.fused_extras_layout(out)
    if tuple(out) != _EXTRAS_LAYOUT:
        raise RuntimeError(f"fused_extras: the kernel's layout {tuple(out)} "
                           f"is not the launch plan's {_EXTRAS_LAYOUT}")
    _layout_checked.add("fused_extras")


def _resident_clusters(lib, device, cs: int, w_bf16: bool) -> int:
    key = (device.index, cs, w_bf16)
    if key not in _max_clusters:
        with torch.cuda.device(device):
            n = lib.fused_extras_max_clusters(cs, int(w_bf16))
        if n < 0:
            raise RuntimeError(f"fused_extras: occupancy query failed: "
                               f"{lib.cuda_error_string(-n).decode()}")
        _max_clusters[key] = n
    return _max_clusters[key]


def fused_extras_cuda(cls: torch.Tensor, p, g_prompt: torch.Tensor, *,
                      Tb: int, num_heads: int, le_pad: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/fused_extras.cu on the current stream (no sync). cls
    (BT, D) bf16 or fp32, rows any stride; the five (D, D) weights all bf16
    or all fp32, contiguous; the vectors and prompts of any float dtype.
    The launch is cooperative: it raises when other work keeps the plan's
    blocks from all being resident at once."""
    from ._cuda import load_library
    BT, D, G = _check_shapes(cls, g_prompt, Tb, num_heads, le_pad)
    a = p["summary_attn"]
    lins = [p["cls_proj"]] + [a[n] for n in ("q", "k", "v", "out")]
    weights = [l["kernel"] for l in lins]
    tensors = [cls, g_prompt, p["local_prompts"], p["summary_ln"]["scale"],
               p["summary_ln"]["bias"]] + weights + [l["bias"] for l in lins]
    for t in tensors:
        if not t.is_cuda or t.device != cls.device:
            raise ValueError(f"fused_extras kernel needs every tensor on "
                             f"one CUDA device, got {cls.device} and "
                             f"{t.device}")
    if cls.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_extras kernel takes bfloat16 or float32 "
                        f"cls rows, got {cls.dtype}")
    wdtype = weights[0].dtype
    if wdtype not in (torch.bfloat16, torch.float32) or \
            any(w.dtype != wdtype for w in weights):
        raise TypeError("fused_extras kernel takes its five weights all "
                        "bfloat16 or all float32, got "
                        f"{[str(w.dtype) for w in weights]}")
    for w in weights:
        if tuple(w.shape) != (D, D) or not w.is_contiguous() or \
                w.data_ptr() % 16:
            raise ValueError(f"fused_extras kernel: contiguous 16-byte "
                             f"aligned ({D}, {D}) weights expected, got "
                             f"{tuple(w.shape)}")
    # rows read four values a load: a stride of a multiple of 4, 16 bytes
    # aligned
    if cls.stride(1) != 1 or cls.stride(0) % 4 or cls.data_ptr() % 16:
        cls = cls.contiguous()
    bc, bq, bk, bv, bo = (_f32(l["bias"], (D,), "bias") for l in lins)
    lns = _f32(p["summary_ln"]["scale"], (D,), "summary_ln scale")
    lnb = _f32(p["summary_ln"]["bias"], (D,), "summary_ln bias")
    lp = _f32(p["local_prompts"], (Tb, D), "local_prompts")
    gp = _f32(g_prompt, (G, D), "global prompts")
    dev = cls.device
    e = torch.empty((BT, le_pad, D), dtype=cls.dtype, device=dev)
    summary = torch.empty((BT, D), dtype=cls.dtype, device=dev)
    if BT:
        lib = load_library("fused_extras")
        _check_layout(lib)
        w_bf16 = wdtype == torch.bfloat16
        plan = fused_extras_plan(
            BT // Tb, Tb, D, num_heads,
            _resident_clusters(lib, dev, _EXTRAS_CS, w_bf16))
        ws = torch.empty(plan["workspace_floats"], dtype=torch.float32,
                         device=dev)
        wc, wq, wk, wv, wo = (w.data_ptr() for w in weights)
        # the wrapper's host time is of the kernel's order: the stream and
        # the current device are asked for the cheapest way
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        with (contextlib.nullcontext()
              if dev.index == torch.cuda.current_device()
              else torch.cuda.device(dev)):
            err = lib.fused_extras(
                cls.data_ptr(), cls.stride(0), wc, bc.data_ptr(),
                lns.data_ptr(), lnb.data_ptr(), wq, bq.data_ptr(), wk,
                bk.data_ptr(), wv, bv.data_ptr(), wo, bo.data_ptr(),
                lp.data_ptr(), gp.data_ptr(), e.data_ptr(),
                summary.data_ptr(), ws.data_ptr(), BT // Tb, Tb, G, D,
                num_heads, le_pad, int(w_bf16),
                int(cls.dtype == torch.bfloat16), plan["cs"],
                plan["clusters"], stream)
        if err != 0:
            raise RuntimeError(
                f"fused_extras kernel launch failed: "
                f"{lib.cuda_error_string(err).decode()} ({err})")
        launch_counts["fused_extras"] += 1
    return e, summary.reshape(BT // Tb, Tb, D)


def fused_extras(cls: torch.Tensor, p, g_prompt: torch.Tensor, *, Tb: int,
                 num_heads: int, le_pad: int, impl: str = "kernel"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cls (BT, D) [the x[:, 0] rows] -> (extras (BT, le_pad, D), summary
    (BT // Tb, Tb, D)), both in cls's dtype (JAX `fused_extras`).

    p: the block's param subtree (cls_proj, summary_ln, summary_attn,
    local_prompts); g_prompt (G, D). Each frame row's extras are [global
    (G) | summary (1) | local (Tb) | zero rows up to le_pad]. impl='plain'
    runs the plain version on any device; 'kernel' the plain version on the
    CPU and the CUDA kernel on a card."""
    if impl == "plain" or cls.device.type == "cpu":
        fn = fused_extras_plain
    elif impl != "kernel":
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    elif cls.device.type == "cuda":
        fn = fused_extras_cuda
    else:
        raise ValueError(f"no fused_extras kernel for device {cls.device}")
    return fn(cls, p, g_prompt, Tb=Tb, num_heads=num_heads, le_pad=le_pad)
