"""The training path past ``chunk_size`` (512), on the CPU, and the
flash-attention autograd Function.

* ``LM.loss_fn`` of ``internlm2-1.8b-smoke`` (dense GQA) and
  ``deepseek-v2-236b-noexperts-smoke`` (MLA, qk width 48 beside v width
  32) at S = 600 (the JAX ``chunked_attention`` branch) and S = 1024
  (``chunked_attention_tri``): the loss within 1e-5 relative and every
  gradient within 1e-6 + 1e-4 · max |g| of JAX's, the port's attention
  running through ``FlashAttentionFn`` (its plain version here).
* ``FlashAttentionFn``'s gradients equal plain autograd through
  ``flash_attention_ref`` — GQA groups, the causal offset ``Skv - Sq``,
  rows that see no key, both width pairs, chunked over rows and KV heads
  or not — and past ``chunk_size`` with grad on the attention's output
  has the Function as its ``grad_fn``; with grad off it has none and the
  entry runs as in serving.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import FlashAttentionFn, ref
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import attention

from torch_serving_pairs import one_cpu_thread  # noqa: F401 (autouse)
from torch_training_pairs import (batch_for, check_grads, check_loss,
                                  jax_run, port_model, port_run)


@pytest.mark.parametrize("S", [600, 1024])
@pytest.mark.parametrize("arch", ["internlm2-1.8b-smoke",
                                  "deepseek-v2-236b-noexperts-smoke"])
def test_long_loss_and_grads_match_jax(arch, S):
    cfg = get_config(arch)
    batch = batch_for(cfg, 1, S, seed=S)
    jparams, jl, ja, jgrads = jax_run(arch, batch)
    model = port_model(arch, jparams, remat=True)
    calls = []
    real = FlashAttentionFn.apply

    def counted(*a):
        calls.append(a[0].shape)
        return real(*a)
    FlashAttentionFn.apply = counted
    try:
        tl, ta, tgrads = port_run(model, batch)
    finally:
        FlashAttentionFn.apply = real
    # each layer's forward and its remat recompute
    assert len(calls) == 2 * cfg.num_layers
    check_loss(jl, ja, tl, ta)
    check_grads(cfg, jgrads, tgrads)


# (B, Sq, Skv, H, K, D, DV, causal)
CASES = [(2, 40, 40, 4, 2, 32, 32, True), (1, 24, 56, 6, 2, 16, 16, True),
         (2, 30, 20, 4, 4, 32, 32, True), (1, 33, 47, 4, 1, 48, 32, True),
         (2, 17, 50, 4, 2, 32, 32, False), (1, 25, 25, 2, 2, 192, 128, False)]


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_function_backward_is_plain_autograd(case, chunked, monkeypatch):
    B, Sq, Skv, H, K, D, DV, causal = case
    if chunked:         # one query head group a chunk: rows and KV heads
        monkeypatch.setattr(ref, "BACKWARD_SCORE_FLOATS",
                            (H // K) * Sq * Skv)
    g = torch.Generator().manual_seed(sum(case[:7]))
    q, k, v = (torch.randn(s, generator=g, dtype=torch.float64).float()
               for s in ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, DV)))
    dout = torch.randn((B, Sq, H, DV), generator=g)
    scale = 0.7 / D ** 0.5
    got = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = FlashAttentionFn.apply(*got, causal, scale)
    out.backward(dout)
    want = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_out = flash_attention_ref(*want, causal=causal, scale=scale)
    ref_out.backward(dout)
    assert torch.equal(out, ref_out)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   atol=1e-6, rtol=1e-5)
    if causal and Sq > Skv:         # rows that see no key: 0, no gradient
        dead = Sq - Skv
        assert not out[:, :dead].any()
        assert not got[0].grad[:, :dead].any()


def test_past_chunk_size_the_output_comes_from_the_function():
    """The trap the Function closes: the kernel writes its output through
    ctypes, so on the card a bare launch has no ``grad_fn``. Past
    ``chunk_size`` with grad on, ``attn_train``'s attention is the
    Function's output; with grad off (serving, prefill) the entry runs
    bare."""
    cfg = get_config("internlm2-1.8b-smoke")
    g = torch.Generator().manual_seed(0)
    d, H, K, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    class P:
        pass
    p = P()
    for n, shape in (("wq", (d, H * D)), ("wk", (d, K * D)),
                     ("wv", (d, K * D)), ("wo", (H * D, d))):
        setattr(p, n, (torch.randn(shape, generator=g) / d ** 0.5)
                .requires_grad_(True))
    x = torch.randn((1, 40, d), generator=g)
    pos = torch.arange(40)[None]
    seen = []
    real = attention.long_attention

    def spy(q, k, v, **kw):
        out = real(q, k, v, **kw)
        seen.append(out.grad_fn)
        return out
    attention.long_attention = spy
    try:
        attention.attn_train(p, cfg, x, pos, chunk_size=16)
        with torch.no_grad():
            attention.attn_train(p, cfg, x, pos, chunk_size=16)
    finally:
        attention.long_attention = real
    assert type(seen[0]).__name__ == "FlashAttentionFnBackward"
    assert seen[1] is None
