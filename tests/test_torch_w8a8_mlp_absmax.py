"""The rule of the fused w8a8 MLP's first fc1 pass (csrc/w8a8_mlp.cuh), on
the CPU: a pass keeps each row's largest pre-activation vmax, and where
QuickGELU(vmax) clears the kernel's kQStar that value is the row's absmax
of the hidden, bit for bit; a block of rows with a row below it takes the
full pass (the absmax of |QuickGELU| over the row). Emulated here in torch
on fp32 rows through the plain version's `quick_gelu_f32`, with the
kernel's blocks of rows, its zero columns past H and its rows past M; the
kernel's own QuickGELU is held to the same two properties on the card
(w8a8_mlp_qgelu_check, chip_smoke.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gava_clip_tpu_torch.ops import int8_matmul as tim
from tests.test_torch_bounds import module_deadline  # noqa: F401

_SRC = (Path(__file__).resolve().parents[1] / "gava_clip_tpu_torch" / "csrc"
        / "w8a8_mlp.cuh").read_text()
Q_STAR = np.float32(float(re.search(r"constexpr float kQStar = ([0-9.]+)f;",
                                    _SRC).group(1)))


def full_absmax(v: torch.Tensor) -> torch.Tensor:
    """The full first pass: each row's max(0, max |QuickGELU(v)|)."""
    return tim.quick_gelu_f32(v).abs().amax(dim=-1).clamp_min(0.0)


def qgelu_of_vmax(v: torch.Tensor) -> torch.Tensor:
    """QuickGELU of each row's max(0, largest pre-activation), taken from
    the one evaluation of QuickGELU over v (torch's CPU sigmoid may round a
    value in a vector's tail otherwise than in its body: the kernel's qgelu
    is one function of its value wherever it is evaluated)."""
    q = tim.quick_gelu_f32(v).gather(-1, v.argmax(dim=-1, keepdim=True))
    return torch.where(v.amax(dim=-1) > 0, q.squeeze(-1), 0.0)


def first_pass_rule(v: torch.Tensor, rows: int, m: int):
    """The kernel's first pass on pre-activations v (Mp, Hp) in blocks of
    `rows` rows, the first `m` of them real: (each row's absmax, per block
    whether it took the full pass)."""
    a = qgelu_of_vmax(v)
    below = ~(a >= torch.from_numpy(np.array(Q_STAR)))
    below[m:] = False                   # rows past M take no part
    full = below.reshape(-1, rows).any(dim=-1)
    out = torch.where(full.repeat_interleave(rows), full_absmax(v), a)
    return out, full


def _rows(kind: str, n: int, h: int, rng) -> np.ndarray:
    if kind == "above":         # the serving case: vmax of a few units
        return rng.standard_normal((n, h)).astype(np.float32) * 3.0
    if kind == "negative":      # every pre-activation below 0
        return -np.abs(rng.standard_normal((n, h))).astype(np.float32) - 1e-3
    if kind == "small_max":     # the max in (0, 0.75), a value at QuickGELU's
        v = rng.uniform(-3.0, 0.0, (n, h)).astype(np.float32)   # least point
        v[:, 0] = np.float32(-0.7512)
        v[:, 1] = rng.uniform(0.0, 0.75, n).astype(np.float32)
        return v
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["above", "negative", "small_max"])
@pytest.mark.parametrize("rows", [64, 192])
def test_rule_is_the_full_absmax_bit_for_bit(kind, rows):
    """Wherever the rule does not fall back its absmax is the full pass's,
    bit for bit; the rows it falls back on are those whose QuickGELU(vmax)
    lies below kQStar."""
    rng = np.random.default_rng(23 + rows)
    v = torch.from_numpy(_rows(kind, 2 * rows, 3072, rng))
    out, full = first_pass_rule(v, rows, v.shape[0])
    assert torch.equal(out, full_absmax(v))
    a = qgelu_of_vmax(v)
    shortcut = ~full.repeat_interleave(rows)
    assert torch.equal(a[shortcut], full_absmax(v)[shortcut])
    if kind == "above":
        assert not full.any()
    if kind == "negative":
        assert full.all()
    if kind == "small_max":
        # rows on both sides of the threshold: each block holds one below
        per_row = ~(a >= torch.from_numpy(np.array(Q_STAR)))
        assert per_row.any() and not per_row.all()
        assert full.all()


def test_rule_near_the_threshold_row_by_row():
    """Rows whose max sits at every float from 0.2 to 0.4 (QuickGELU crosses
    kQStar there) beside a value at QuickGELU's least point: one row a
    block, so each row's own decision shows; the rule is exact on every
    row."""
    vmax = np.arange(np.float32(0.2).view(np.int32),
                     np.float32(0.4).view(np.int32), 97,
                     dtype=np.int32).view(np.float32)
    v = np.full((vmax.size, 256), np.float32(-0.7512), np.float32)
    v[:, 1] = np.float32(-0.74)
    v[:, 2] = vmax
    v = torch.from_numpy(v)
    out, full = first_pass_rule(v, 1, v.shape[0])
    assert torch.equal(out, full_absmax(v))
    assert full.any() and not full.all()
    # on the shortcut rows QuickGELU(vmax) is the absmax even though the
    # row's negative values reach |QuickGELU| ~0.1636
    a = qgelu_of_vmax(v)
    assert torch.equal(a[~full], full_absmax(v)[~full])


def test_rule_with_columns_past_h_and_rows_past_m():
    """The kernel's padding: columns past H give pre-activation 0 (zero
    products, scale and bias), rows past M take no part in the decision.
    A block of shortcut rows with all-negative padding rows after M keeps
    the shortcut; an all-negative real row makes its block fall back."""
    rng = np.random.default_rng(5)
    rows, m, h, hp = 64, 100, 200, 256
    v = np.zeros((128, hp), np.float32)
    v[:m, :h] = _rows("above", m, h, rng)
    v[m:, :h] = _rows("negative", 128 - m, h, rng)    # rows past M
    v = torch.from_numpy(v)
    out, full = first_pass_rule(v, rows, m)
    assert not full.any()
    assert torch.equal(out[:m], full_absmax(v)[:m])
    v[70, :h] = torch.from_numpy(_rows("negative", 1, h, rng)[0])
    out, full = first_pass_rule(v, rows, m)
    assert full.tolist() == [False, True]
    assert torch.equal(out[:m], full_absmax(v)[:m])
    # its padding zeros are its largest pre-activation: QuickGELU(0) = 0
    assert qgelu_of_vmax(v)[70].item() == 0.0 < out[70].item()


def test_rule_gives_the_plain_versions_hidden_scale():
    """Through the plain version's own fc1 (codes, int8 product, rescale)
    on a small MLP: the hidden's row scale from the rule is quant_rows'
    scale of QuickGELU(h) bit for bit."""
    rng = np.random.default_rng(11)
    m, k, h = 96, 64, 384
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, h)).astype(np.float32)) * 0.2
    from gava_clip_tpu_torch.ops.quant import quantize_weight
    qa, scale = quantize_weight(w)
    bias = torch.from_numpy(rng.standard_normal(h).astype(np.float32)) * 0.02
    codes, xs = tim.quant_rows(x)
    pre = tim.rescale(tim.int_matmul(codes, qa), xs, scale, bias)
    pre[:8] = -2.0 - pre[:8].abs()      # a block's worth of negative rows
    out, full = first_pass_rule(pre, 32, m)
    assert full.tolist() == [True, False, False]
    want = tim.quant_rows(tim.quick_gelu_f32(pre))[1].reshape(-1)
    got = torch.clamp(out, min=1e-6) * tim._INV127
    assert torch.equal(got, want)


def test_q_star_bounds_quick_gelu_over_the_negative_floats():
    """kQStar is at or above |QuickGELU| at every float in [-1.6, -0.25]
    (the least point, -0.7512, and around it) and at a grid beyond;
    QuickGELU is non-decreasing over every float in [0.05, 2]."""
    lo, hi = np.float32(0.25).view(np.int32), np.float32(1.6).view(np.int32)
    v = -torch.from_numpy(np.arange(lo, hi, dtype=np.int32).view(np.float32))
    q = tim.quick_gelu_f32(v).abs()
    assert q.max().item() <= float(Q_STAR)
    assert q.max().item() > 0.1636      # the least point was reached
    far = -torch.logspace(-30, 30, 10001, dtype=torch.float64).float()
    assert tim.quick_gelu_f32(far).abs().max().item() <= float(Q_STAR)
    lo, hi = np.float32(0.05).view(np.int32), np.float32(2.0).view(np.int32)
    u = torch.from_numpy(np.arange(lo, hi, 7, dtype=np.int32).view(np.float32))
    g = tim.quick_gelu_f32(u)
    assert bool((g[1:] >= g[:-1]).all())


def test_chip_smoke_fallback_rows_take_the_full_pass():
    """chip_smoke's fallback shape (200 rows of 768 -> 3,072, B5's plan of
    64-row blocks), built on the CPU through the plain version's fc1: the
    blocks holding B5_FALLBACK_ROWS take the full pass and the third block
    the shortcut, and on those rows the shortcut's absmax would be too small
    (their absmax comes from a negative pre-activation)."""
    import chip_smoke
    from gava_clip_tpu_torch.ops.quant import quantize_weight
    rng = np.random.default_rng(3)
    m, k, h = 200, 768, 3072
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, h)).astype(np.float32)) * k ** -0.5
    qa, scale = quantize_weight(w)
    fc1 = {"kernel": {"qa": qa, "scale": scale},
           "bias": torch.from_numpy(rng.standard_normal(h).astype(np.float32)) * 0.02}
    ln = (torch.ones(k), torch.from_numpy(rng.standard_normal(k).astype(np.float32)) * 0.02)
    chip_smoke._b5_fallback_rows(x, fc1, ln)
    codes, xs = tim.quant_rows(tim.ln_f32(x, *ln))
    pre = tim.rescale(tim.int_matmul(codes, qa), xs, scale, fc1["bias"])
    rows = tim.w8a8_mlp_plan(m, k, h, 768, 132, 232448)["rows"]
    v = torch.zeros(-(-m // rows) * rows, h)
    v[:m] = pre
    out, full = first_pass_rule(v, rows, m)
    assert rows == 64 and full.tolist() == [True, True, False, True]
    assert torch.equal(out[:m], full_absmax(v)[:m])
    fb = list(chip_smoke.B5_FALLBACK_ROWS)
    assert torch.equal(pre[fb], fc1["bias"].expand(len(fb), -1))
    assert bool((qgelu_of_vmax(v)[fb] * 4 < out[fb]).all())
