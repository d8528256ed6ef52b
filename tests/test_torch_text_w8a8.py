"""The port's text transformer with every linear in w8a8 against the JAX
package's on the CPU: the fused q/k/v projection (`w8a8_matmul3`), the
out-projection, fc1 and fc2 (`w8a8_matmul`; fc2 takes rows of the MLP's
hidden width, 2,048 at the text tower's width of 512, which the w8a8 GEMM
kernel holds in passes over the row). The JAX side runs its Pallas kernels
in interpret mode through `force_tpu_kernels(True)`; the port's CPU path is
the plain versions. Both sides quantize the same fp32 weights with the JAX
quantizer, and the prompts come from numpy.

Tolerance: the two sides compute the same int8 codes and the same fp32
epilogues; they differ in the order of the LayerNorm, softmax and attention
sums, which moves a value by fp32 ulps and can flip an int8 code that sits
on a rounding tie (one output in ~80 after the first block). The causal
attention carries a flipped row into every later row of its prompt, so
after two blocks many rows differ, each by a few flip units: every output
within 1e-2 of the largest |output| and the mean difference within 1e-3 of
it (measured 6.5e-3 and 3.3e-4; the w8a8 tower's own distance from the
float tower on these weights is 1.6e-2 and 2.2e-3).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gava_clip_tpu.models import text as jtext
from gava_clip_tpu.ops import int8_matmul as jim
from gava_clip_tpu.ops.quant import quantize_weight as jquantize_weight
from gava_clip_tpu_torch.models import text as ttext
from gava_clip_tpu_torch.ops import int8_matmul as tim
from gava_clip_tpu_torch.utils import jax_bridge
from tests.test_torch_bounds import module_deadline  # noqa: F401

JCFG = jtext.TextConfig(embed_dim=64, context_length=77, vocab_size=100,
                        width=512, heads=8, layers=2)
CFG = ttext.TextConfig(**dataclasses.asdict(JCFG))
LINEARS = (("attn", ("q", "k", "v", "out")), ("mlp", ("fc1", "fc2")))


@pytest.fixture
def forced_kernels():
    """The JAX Pallas kernels in interpret mode; the flag is process-global
    (xdist runs other files in the same worker), so it is reset here."""
    jim.force_tpu_kernels(True)
    assert jim.kernels_active()
    yield
    jim.force_tpu_kernels(False)


def _w8a8_params():
    """The JAX text tower's init, every block linear quantized per layer by
    the JAX quantizer, in both packages' trees."""
    jp = jax.tree_util.tree_map(
        np.asarray, jtext.init_text_params(jax.random.PRNGKey(5), JCFG))
    tp = jax_bridge._convert(jp, ttext.init_text_params(None, CFG,
                                                        device="meta"),
                             "", None)
    for group, names in LINEARS:
        for name in names:
            leaf = jp["blocks"][group][name]
            qs = [jquantize_weight(w) for w in leaf["kernel"]]
            leaf["kernel"] = {"qa": np.stack([q for q, _ in qs]),
                              "scale": np.stack([s for _, s in qs])}
            for layer, (q, s) in enumerate(qs):
                tp["blocks"][layer][group][name]["kernel"] = {
                    "qa": torch.from_numpy(np.asarray(q)),
                    "scale": torch.from_numpy(np.asarray(s))}
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    return jp, tp


def test_w8a8_text_transformer_matches_jax(forced_kernels):
    jp, tp = _w8a8_params()
    assert tp["blocks"][0]["mlp"]["fc2"]["kernel"]["qa"].shape == (2048, 512)
    rs = np.random.RandomState(6)
    x = (0.5 * rs.randn(2, JCFG.context_length, JCFG.width)
         ).astype(np.float32)
    want = np.asarray(jtext.text_transformer(jp, jnp.asarray(x), JCFG))
    tim.reset_launch_counts()
    got = ttext.text_transformer(tp, torch.from_numpy(x), CFG).numpy()
    # the CPU path runs the plain versions, never a kernel
    assert not any(tim.launch_counts.values())
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    scale = np.abs(want).max()
    assert err.max() <= 1e-2 * scale, err.max() / scale
    assert err.mean() <= 1e-3 * scale, err.mean() / scale
