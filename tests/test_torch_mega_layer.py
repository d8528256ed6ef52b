"""The port's tool `gava_clip_tpu_torch/tools/bench_attn_variants.py` held
against the JAX package's `tools/bench_attn_variants.py` (loaded from its
path, unchanged): the whole-layer w8a8 `mega_layer` (TPU `_mega_kernel`,
interpret mode here) against the port's plain version, at two frame rows
of full width (197 + 17 rows, D 768, 12 heads; the JAX BlockSpec fixes the
hidden width at 3,072) and at a small width; the serving composition
`base_layer` with the JAX Pallas kernels forced; the parameters, their
conversion, the dispatch and the tool's entry point.

Tolerance: both sides compute the same int8 codes and fp32 epilogues,
except where a LayerNorm, softmax or attention sum taken in another order
moves a value across a rounding tie. A tie flip in a k or v row of the
first quant moves every query's softmax, so on some draws most outputs of
a frame row differ by a little (seen over 7 draws: up to 41% of outputs
differ, 11% by more than 2 bf16 ulp); the first-stage flips reach the
output through LN2 and the whole 3,072-wide hidden row, so the ceiling is
counted in flip units of the hidden's quant (xs_hidden * s2 * 127): every
output within 2 bf16 ulp + 20 such units (seen at most 15.5), at most 15%
beyond 2 ulp.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gava_clip_tpu.ops import int8_matmul as jim
from gava_clip_tpu_torch.ops import int8_matmul as tim
from gava_clip_tpu_torch.tools import bench_attn_variants as tool
from tests.test_torch_bounds import module_deadline  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_UNITS, _FAR_SHARE = 20.0, 0.15


@pytest.fixture(scope="module")
def jtool():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_attn_variants",
        os.path.join(ROOT, "tools", "bench_attn_variants.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def forced_kernels():
    """The JAX Pallas kernels in interpret mode for the JAX base_layer; the
    flag is process-global, so it is reset here."""
    jim.force_tpu_kernels(True)
    yield
    jim.force_tpu_kernels(False)


def _jax_tree(t):
    if isinstance(t, dict):
        return {k: _jax_tree(v) for k, v in t.items()}
    if isinstance(t, tuple):
        return tuple(_jax_tree(v) for v in t)
    return jnp.asarray(t)


def _draw(seed, frames, lx, le, d, h):
    """The tool's parameters and inputs, numpy, drawn in its order."""
    rs = np.random.RandomState(seed)
    params = tool.make_params(rs, d, h)
    x = rs.randn(frames, lx, d).astype(np.float32) * 0.1
    e = rs.randn(frames, le, d).astype(np.float32) * 0.1
    return params, x, e


def _run_jax(fn, params, x, e, **kw):
    bf = jnp.bfloat16
    out = fn(jnp.asarray(x).astype(bf), jnp.asarray(e).astype(bf),
             *(_jax_tree(p) for p in params), **kw)
    return np.asarray(out.astype(jnp.float32))


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _assert_close(out_t, out_j, unit):
    a, b = out_t.float().numpy(), out_j
    assert a.shape == b.shape and np.isfinite(a).all()
    err = np.abs(a - b)
    two_ulp = 2 * _bf16_ulp(np.maximum(abs(a), abs(b)))
    assert np.all(err <= two_ulp + _UNITS * unit), \
        ((err - two_ulp) / unit).max()
    assert (err > two_ulp).mean() <= _FAR_SHARE


def _hidden_unit(xs_hidden, mlp_p):
    return xs_hidden.numpy() * \
        mlp_p["fc2"]["kernel"]["scale"].numpy().reshape(-1) * 127.0


@pytest.mark.parametrize("frames,lx,le,d,heads", [(2, 197, 17, 768, 12),
                                                   (2, 20, 5, 128, 2)])
def test_mega_layer_plain_matches_jax_mega_layer(jtool, frames, lx, le, d,
                                                 heads):
    """The plain version against the JAX whole-layer kernel in interpret
    mode, on the tool's draws: full width, and D 128 with 2 heads."""
    params, x, e = _draw(0, frames, lx, le, d, tool.H)
    out_j = _run_jax(jtool.mega_layer, params, x, e, heads=heads)
    tp = tool.params_to_port(*params)
    xt = torch.from_numpy(x).bfloat16()
    et = torch.from_numpy(e).bfloat16()
    out_t = tool.mega_layer(xt, et, *tp, heads=heads)
    assert out_t.shape == (frames, lx, d) and out_t.dtype == torch.bfloat16
    y32, xs_hidden = tool.mega_layer_f32(xt, et, *tp, heads=heads)
    torch.testing.assert_close(y32.bfloat16(), out_t, rtol=0, atol=0)
    _assert_close(out_t, out_j, _hidden_unit(xs_hidden, tp[1]))


def test_base_layer_matches_jax_base_layer(jtool, forced_kernels):
    """The serving composition (B3a, B4, B5 plain versions) against the
    JAX composition with its Pallas kernels, two frame rows."""
    params, x, e = _draw(0, 2, tool.Lx, tool.Lext, tool.D, tool.H)
    out_j = _run_jax(jtool.base_layer, params, x, e)
    tp = tool.params_to_port(*params)
    xt = torch.from_numpy(x).bfloat16()
    et = torch.from_numpy(e).bfloat16()
    out_t = tool.base_layer(xt, et, *tp)
    assert out_t.shape == xt.shape and out_t.dtype == torch.bfloat16
    # the hidden's row scales of B5 on this composition's residual
    kv = torch.cat([xt, et], dim=1)
    q, k, v = (o.reshape(kv.shape) for o in tim.w8a8_matmul3(
        kv.reshape(-1, tool.D), [tp[0][n]["kernel"] for n in "qkv"],
        [tp[0][n]["bias"] for n in "qkv"], ln=tp[2]))
    from gava_clip_tpu_torch.ops.flash_attention import \
        flash_attention_out_int8
    x1 = flash_attention_out_int8(q[:, :tool.Lx], k, v, tool.HEADS,
                                  tp[0]["out"], xt).float()
    codes, xs = tim.quant_rows(tim.ln_f32(x1, *tp[3]))
    fc1 = tp[1]["fc1"]
    h = tim.quick_gelu_f32(tim.rescale(tim.int_matmul(codes, fc1["kernel"]
                                                      ["qa"]), xs,
                                       fc1["kernel"]["scale"], fc1["bias"]))
    _assert_close(out_t, out_j, _hidden_unit(tim.quant_rows(h)[1], tp[1]))


def test_make_params_bit_equal_to_the_jax_tool(jtool):
    ours = tool.make_params(np.random.RandomState(0))
    theirs = jtool.make_params(np.random.RandomState(0))
    flat_o, flat_t = [], []

    def walk(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for key in a:
                walk(a[key], b[key])
        elif isinstance(a, tuple):
            for u, w in zip(a, b):
                walk(u, w)
        else:
            flat_o.append(a)
            flat_t.append(np.asarray(b))
    walk(ours, theirs)
    assert len(flat_o) == 6 * 3 + 4
    for a, b in zip(flat_o, flat_t):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_params_round_trip_and_kernel_layout():
    """Every leaf of the JAX-shaped tree comes back from the port's leaves
    unchanged, and each kernel leaf carries the W^T the kernels read."""
    params = tool.make_params(np.random.RandomState(1), 128, 256)
    port = tool.params_to_port(*params)
    for leaf in list(port[0].values()) + list(port[1].values()):
        k = leaf["kernel"]
        torch.testing.assert_close(k["qa_t"], k["qa"].t().contiguous(),
                                   rtol=0, atol=0)
    ours, theirs = _leaves(port), _leaves(params)
    assert len(ours) == len(theirs) == 6 * 3 + 4
    for a, b in zip(ours, theirs):
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)


def _leaves(tree):
    """The arrays of a tool tree in a fixed order (the kernels' W^T copies
    skipped)."""
    if isinstance(tree, dict):
        return [v for key in sorted(tree) if key != "qa_t"
                for v in _leaves(tree[key])]
    if isinstance(tree, tuple):
        return [v for t in tree for v in _leaves(t)]
    return [tree]


def test_cpu_runs_the_plain_version_and_never_reaches_cuda(monkeypatch):
    params, x, e = _draw(2, 2, 9, 3, 128, 256)
    tp = tool.params_to_port(*params)
    xt = torch.from_numpy(x).bfloat16()
    et = torch.from_numpy(e).bfloat16()

    def no_cuda(*a, **k):
        raise AssertionError("the CUDA wrapper was reached on the CPU")
    monkeypatch.setattr(tool, "mega_layer_cuda", no_cuda)
    tool.reset_launch_counts()
    out = tool.mega_layer(xt, et, *tp, heads=2)
    torch.testing.assert_close(
        out, tool.mega_layer_plain(xt, et, *tp, heads=2), rtol=0, atol=0)
    assert tool.launch_counts["mega_layer"] == 0
    with pytest.raises(ValueError, match="impl"):
        tool.mega_layer(xt.to("meta"), et, *tp, heads=2, impl="fast")
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        tool.mega_layer_cuda(xt, et, *tp, heads=2)


def test_mega_layer_plan():
    """One CTA an SM: a frame row takes as many CTAs (one cluster) as it has
    tiles of 128 kv or query rows where every CTA then has an SM of its
    own, else one, which takes all its tiles."""
    assert tool.mega_layer_plan(64, 132) == {"split": 2, "grid": (2, 64),
                                             "tiles": (2, 2)}
    assert tool.mega_layer_plan(128, 132) == {"split": 1, "grid": (1, 128),
                                              "tiles": (2, 2)}
    assert tool.mega_layer_plan(3, 132, 50, 5)["split"] == 1
    assert tool.mega_layer_plan(1000, 132)["split"] == 1
    with pytest.raises(ValueError):
        tool.mega_layer_plan(0, 132)


def test_main_parity_on_the_cpu_prints_the_jax_tool_line(capsys):
    assert tool.main(["--parity", "--device", "cpu", "--frames", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("parity max abs diff ")
    assert "(rel " in lines[0] and lines[1] == "PARITY OK"
    assert tool.main(["--device", "cpu", "--frames", "1"]) == 2
