"""The port's Zamba2 hybrid stack against the JAX package's, fp32 on the
CPU.

``zamba2-1.2b-smoke`` has 2 layers at period 2 and one shared block: no
tail and nothing to alternate, and its LoRA ``b`` starts at zero. So the
model here is cut to 5 layers with 2 shared blocks (2 segments, the
blocks alternating, a tail of 1) and a nonzero LoRA ``b``
(``torch_serving_pairs.hybrid_models``). Logits agree within 1e-4 of the
reference's largest magnitude and every cache key within 1e-5: prefill,
decode steps after it, and a prompt past the attention ``chunk_size``
(the shared blocks through ``attn_train``'s flash branch, its plain
version here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_serving_pairs import hybrid_models
from torch_serving_pairs import one_cpu_thread  # noqa: F401 (autouse)

LOGIT_RTOL = 1e-4
CACHE_RTOL = 1e-5
KEYS = {"pos", "seg_conv", "seg_ssm", "shared_k", "shared_v", "tail_conv",
        "tail_ssm"}


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


def _caches_close(tc, jc):
    assert set(tc) == set(jc) == KEYS
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for k in KEYS - {"pos"}:
        _close(tc[k], jc[k], CACHE_RTOL)


def test_structure_is_cut_to_show():
    _, _, tmodel = hybrid_models()
    assert (tmodel.n_seg, tmodel.seg_len, tmodel.tail_len) == (2, 2, 1)
    assert len(tmodel.shared_blocks) == 2 and len(tmodel.loras) == 2
    assert all(bool(lora.b.abs().sum() > 0) for lora in tmodel.loras)
    # the two shared blocks differ, so alternation shows
    a, b = tmodel.shared_blocks
    assert not torch.equal(a.wq, b.wq)
    assert tmodel.cache_descriptor() is None


@pytest.mark.parametrize("chunk_size,S", [(512, 11), (16, 40)])
def test_prefill_and_decode_match_jax(chunk_size, S):
    """S = 11 within ``chunk_size``; S = 40 past 16 (the flash branch)."""
    jmodel, jparams, tmodel = hybrid_models(chunk_size)
    rng = np.random.default_rng(S)
    toks = rng.integers(0, 512, (2, S)).astype(np.int32)
    max_len = S + 8
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len)
    tl, tc = tmodel.prefill(torch.from_numpy(toks), max_len)
    _close(tl, jl, LOGIT_RTOL)
    _caches_close(tc, jc)
    for _ in range(3):
        nxt = rng.integers(0, 512, (2, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(nxt), jc["pos"])
        tl, tc = tmodel.decode_step(tc, torch.from_numpy(nxt), tc["pos"])
        _close(tl, jl, LOGIT_RTOL)
        _caches_close(tc, jc)


def test_unfolded_lora_would_differ():
    """The LoRA delta reaches the logits: the same model with every ``b``
    at zero gives other logits."""
    _, _, tmodel = hybrid_models()
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, 512, (1, 9)).astype(np.int32))
    with_lora, _ = tmodel.prefill(toks, 16)
    saved = [lora.b.detach().clone() for lora in tmodel.loras]
    try:
        for lora in tmodel.loras:
            lora.b.data.zero_()
        without, _ = tmodel.prefill(toks, 16)
    finally:
        for lora, b in zip(tmodel.loras, saved):
            lora.b.data.copy_(b)
    assert float((with_lora - without).abs().max()) > 1e-3


def test_ragged_step_is_refused():
    """No cache descriptor: the hybrid has no ragged step, as in JAX."""
    _, _, tmodel = hybrid_models()
    assert not tmodel.supports_ragged_step()
    with pytest.raises(ValueError, match="no cache descriptor"):
        tmodel.step_ragged({}, torch.zeros((1, 1), dtype=torch.long),
                           torch.zeros(1), torch.ones(1))
