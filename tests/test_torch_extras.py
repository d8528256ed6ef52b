"""The port's fused prompt extras on the CPU: `fused_extras` (its plain
version) against the JAX Pallas kernel in interpret mode and against the
port's own stock-op branch, the switch in the vision block, and the wrapper's
dispatch.

Both sides compute in fp32 whatever the inputs; only the order of the fp32
sums differs: 2e-5 (absolute and relative), the JAX package's own bound
against its stock composition (tests/test_extras_kernel.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gava_clip_tpu.ops.extras_kernel import fused_extras as jfused_extras
from gava_clip_tpu_torch.models.vision import (VisionConfig, _block,
                                               init_vision_params,
                                               prompt_extras)
from gava_clip_tpu_torch.ops import extras_kernel as tek
from gava_clip_tpu_torch.ops.int8_matmul import with_kernel_layout
from gava_clip_tpu_torch.ops.quant import quantize_tower_params
from tests.test_torch_bounds import module_deadline  # noqa: F401

# (Bb, Tb, G, heads, D): the geometries of the JAX package's fuzz test, and
# one whose head dim is no power of two
GEOMETRIES = [(1, 2, 1, 1, 16), (2, 4, 3, 2, 32), (5, 2, 2, 4, 32),
              (3, 8, 8, 2, 64), (2, 3, 2, 2, 40)]


def _params(rs, Tb, G, D):
    def lin():
        return {"kernel": rs.randn(D, D).astype(np.float32) * 0.1,
                "bias": rs.randn(D).astype(np.float32) * 0.01}

    p = {"cls_proj": lin(),
         "summary_ln": {"scale": np.abs(rs.randn(D)).astype(np.float32) + 0.5,
                        "bias": rs.randn(D).astype(np.float32) * 0.1},
         "summary_attn": {n: lin() for n in ("q", "k", "v", "out")},
         "local_prompts": rs.randn(Tb, D).astype(np.float32) * 0.1}
    return p, rs.randn(G, D).astype(np.float32) * 0.1


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("Bb,Tb,G,H,D", GEOMETRIES)
@pytest.mark.parametrize("pad", [0, 5])
def test_fused_extras_matches_jax_kernel(Bb, Tb, G, H, D, pad):
    rs = np.random.RandomState(9)
    p, g = _params(rs, Tb, G, D)
    cls = rs.randn(Bb * Tb, D).astype(np.float32) * 0.2
    le = G + 1 + Tb
    kw = dict(Tb=Tb, num_heads=H, le_pad=le + pad)
    e_j, s_j = jfused_extras(jnp.asarray(cls), _map(jnp.asarray, p),
                             jnp.asarray(g), **kw)
    tp = _map(torch.from_numpy, p)
    # the port keeps local_prompts as (1, Tb, D)
    tp["local_prompts"] = tp["local_prompts"][None]
    e_t, s_t = tek.fused_extras(torch.from_numpy(cls), tp,
                                torch.from_numpy(g), **kw)
    assert e_t.shape == (Bb * Tb, le + pad, D) and s_t.shape == (Bb, Tb, D)
    assert e_t.dtype == s_t.dtype == torch.float32
    np.testing.assert_allclose(_np(e_t), _np(e_j), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(s_t), _np(s_j), atol=2e-5, rtol=2e-5)
    assert (e_t[:, le:] == 0).all()                     # pad rows
    np.testing.assert_array_equal(_np(e_t[:, :G]),
                                  np.broadcast_to(g, (Bb * Tb, G, D)))


@pytest.mark.parametrize("le_pad", [17, 24])
def test_fused_extras_matches_jax_kernel_at_serving_width(le_pad):
    """ViT-B/16's width, the serving path's geometry (Bb 2 clips, Tb 8, G 8,
    12 heads, D 768): the plain version (the CUDA kernel's reference on the
    card) against the JAX kernel in interpret mode, fp32, with zero pad rows
    at le_pad 24. Weights of std D^-0.5 keep the activations of order one;
    the bound is chip_smoke's EXTRAS_TOL, 2e-5 of max(1, largest |output|):
    only the order of the fp32 sums differs."""
    rs = np.random.RandomState(13)
    Bb, Tb, G, H, D = 2, 8, 8, 12, 768

    def lin():
        return {"kernel": rs.randn(D, D).astype(np.float32) * D ** -0.5,
                "bias": rs.randn(D).astype(np.float32) * 0.02}

    p = {"cls_proj": lin(),
         "summary_ln": {"scale": 1 + 0.1 * rs.randn(D).astype(np.float32),
                        "bias": rs.randn(D).astype(np.float32) * 0.02},
         "summary_attn": {n: lin() for n in ("q", "k", "v", "out")},
         "local_prompts": rs.randn(Tb, D).astype(np.float32) * 0.05}
    g = rs.randn(G, D).astype(np.float32) * 0.05
    cls = rs.randn(Bb * Tb, D).astype(np.float32)
    kw = dict(Tb=Tb, num_heads=H, le_pad=le_pad)
    e_j, s_j = jfused_extras(jnp.asarray(cls), _map(jnp.asarray, p),
                             jnp.asarray(g), **kw)
    tp = _map(torch.from_numpy, p)
    tp["local_prompts"] = tp["local_prompts"][None]
    e_t, s_t = tek.fused_extras_plain(torch.from_numpy(cls), tp,
                                      torch.from_numpy(g), **kw)
    assert e_t.shape == (Bb * Tb, le_pad, D) and s_t.shape == (Bb, Tb, D)
    for got, want in ((_np(e_t), _np(e_j)), (_np(s_t), _np(s_j))):
        tol = 2e-5 * max(1.0, np.abs(want).max())
        assert np.abs(got - want).max() <= tol
    le = G + 1 + Tb
    assert (e_t[:, le:] == 0).all()
    np.testing.assert_array_equal(_np(e_t[:, :G]),
                                  np.broadcast_to(g, (Bb * Tb, G, D)))


def test_fused_extras_bf16_inputs_match_jax_kernel():
    """bf16 cls rows and bf16 weights: cast up, fp32 arithmetic, outputs
    rounded once to bf16 on both sides: at most one bf16 ulp apart."""
    rs = np.random.RandomState(10)
    Bb, Tb, G, H, D = 3, 4, 2, 2, 32
    p, g = _params(rs, Tb, G, D)
    cls = rs.randn(Bb * Tb, D).astype(np.float32) * 0.2
    kw = dict(Tb=Tb, num_heads=H, le_pad=8)
    e_j, s_j = jfused_extras(
        jnp.asarray(cls).astype(jnp.bfloat16),
        _map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), p),
        jnp.asarray(g).astype(jnp.bfloat16), **kw)
    tp = _map(lambda a: torch.from_numpy(a).bfloat16(), p)
    e_t, s_t = tek.fused_extras(torch.from_numpy(cls).bfloat16(), tp,
                                torch.from_numpy(g).bfloat16(), **kw)
    assert e_t.dtype == s_t.dtype == torch.bfloat16
    for a, b in ((_np(e_t), _np(e_j)), (_np(s_t), _np(s_j))):
        mag = np.maximum(np.maximum(abs(a), abs(b)), 1e-30)
        assert np.all(np.abs(a - b) <= np.exp2(np.floor(np.log2(mag)) - 7))


def _tower(dtype=torch.float32, **over):
    cfg = VisionConfig(**{**dict(
        input_size=(32, 32), num_frames=2, feature_dim=32,
        patch_size=(16, 16), heads=2, layers=1, mlp_factor=2.0, embed_dim=16,
        use_summary_token=True, use_local_prompts=True,
        use_global_prompts=True, num_global_prompts=2), **over})
    params = init_vision_params(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(3 * cfg.num_frames, 5, cfg.feature_dim,
                    generator=torch.Generator().manual_seed(1)).to(dtype)
    return cfg, params, x


def test_fused_extras_matches_stock_branch():
    """fp32 activations: the stock ops of the block compute the same rows
    (the JAX package holds its kernel to that composition at 2e-5)."""
    cfg, params, x = _tower()
    p, g = params["blocks"][0], params["global_prompts"][0]
    extras, summary = prompt_extras(p, g, x, cfg)
    e, s = tek.fused_extras(x[:, 0], p, g, Tb=cfg.num_frames,
                            num_heads=cfg.heads, le_pad=5)
    np.testing.assert_allclose(_np(e), _np(torch.cat(extras, dim=1)),
                               atol=2e-5, rtol=2e-5)
    # the block's summary rows (BT, D) are the kernel's (Bb, Tb, D)
    np.testing.assert_allclose(_np(s), _np(summary.reshape(s.shape)),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("attn_impl,taken", [("flash", True), ("xla", False)])
def test_block_switch(attn_impl, taken):
    """The block takes the fused branch when the switch is on, the block is
    w8a8 with the fused out-projection and all three prompt kinds are on;
    the flag is read at every call. With fp32 activations the block's
    output then moves by fp32 noise only."""
    cfg, params, x = _tower()
    q = quantize_tower_params({"visual": params},
                              act_quant=True)["visual"]
    p, g = with_kernel_layout(q["blocks"][0]), params["global_prompts"][0]
    calls = []
    real = tek.fused_extras

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    assert not tek.FUSED_EXTRAS
    base, base_sum = _block(p, g, x, cfg, attn_impl)
    tek.fused_extras = spy
    try:
        _block(p, g, x, cfg, attn_impl)
        assert calls == []                              # the switch is off
        tek.set_fused_extras(True)
        try:
            out, out_sum = _block(p, g, x, cfg, attn_impl)
            # a float block never takes it
            _block(params["blocks"][0], g, x, cfg, attn_impl)
        finally:
            tek.set_fused_extras(False)
    finally:
        tek.fused_extras = real
    assert len(calls) == int(taken)
    if taken:
        assert calls[0]["le_pad"] == 2 + 1 + 2 and calls[0]["Tb"] == 2
    np.testing.assert_allclose(_np(out), _np(base), atol=1e-4)
    np.testing.assert_allclose(_np(out_sum), _np(base_sum), atol=1e-4)
    assert not tek.FUSED_EXTRAS


def test_block_switch_needs_every_prompt_kind():
    cfg, params, x = _tower(use_local_prompts=False)
    q = quantize_tower_params({"visual": params}, act_quant=True)["visual"]
    p, g = q["blocks"][0], params["global_prompts"][0]
    tek.set_fused_extras(True)
    try:
        real, tek.fused_extras = tek.fused_extras, None    # would raise
        try:
            out, _ = _block(p, g, x, cfg, "flash")
        finally:
            tek.fused_extras = real
    finally:
        tek.set_fused_extras(False)
    assert torch.isfinite(out).all()


def test_wrapper_dispatch_and_checks():
    cfg, params, x = _tower()
    p, g = params["blocks"][0], params["global_prompts"][0]
    kw = dict(Tb=2, num_heads=2, le_pad=5)
    tek.reset_launch_counts()
    e, _ = tek.fused_extras(x[:, 0], p, g, **kw)          # CPU: plain version
    assert tek.launch_counts["fused_extras"] == 0
    torch.testing.assert_close(
        tek.fused_extras(x[:, 0], p, g, impl="plain", **kw)[0], e,
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tek.fused_extras_cuda(x[:, 0], p, g, **kw)
    with pytest.raises(ValueError, match="impl"):
        tek.fused_extras(x[:, 0].to("meta"), p, g, impl="fast", **kw)
    with pytest.raises(ValueError, match="le_pad"):
        tek.fused_extras(x[:, 0], p, g, Tb=2, num_heads=2, le_pad=4)
    with pytest.raises(ValueError, match="multiple of Tb"):
        tek.fused_extras(x[:5, 0], p, g, **kw)
    with pytest.raises(ValueError, match="heads"):
        tek.fused_extras(x[:, 0], p, g, Tb=2, num_heads=3, le_pad=5)


def test_env_switch():
    """GAVA_FUSED_EXTRAS=1 / GAVA_INT8_QK=1 arm the switches at import, as
    in the JAX package (a fresh interpreter: the flags are read once)."""
    import os
    import subprocess
    import sys
    code = ("from gava_clip_tpu_torch.ops import extras_kernel as e, "
            "flash_attention as f; "
            "print(e.FUSED_EXTRAS, f._INT8_QK)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for flags, want in ((("1", "1"), "True True"), (("0", ""), "False False")):
        env = dict(os.environ, GAVA_FUSED_EXTRAS=flags[0],
                   GAVA_INT8_QK=flags[1], PYTHONPATH=root)
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, check=True,
                             timeout=120)
        assert out.stdout.strip() == want
