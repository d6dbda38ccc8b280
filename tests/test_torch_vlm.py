"""The VLM family (LLaVA-NeXT-Mistral-7B) on the port against the JAX
package, on the CPU, with the JAX ``init`` weights carried across; and the
refusal, in both packages, of a VLM or encoder-decoder prefill without its
frontend embeddings.

* the projector (tanh-GELU between its layers) against JAX's;
* ``LM.prefill`` + ``decode_step`` of ``llava-next-mistral-7b-smoke``,
  native and int8 cache, against the JAX ``LM`` at ``chunk_size=32``, with
  the frontend inputs of ``tests/test_models_smoke.py`` (16 image patches
  of width 64): the patches go before the text, so the 56-token prompt
  passes ``chunk_size`` (the flash kernel's plain version, causal); a
  cache longer than ``max_len`` is never cut;
* a replay of ``test_decode_matches_full_forward``.

Tolerances (fp32): logits atol 1e-4, rtol 2e-5; cache planes atol 1e-5
(int8 codes within one step, bf16 scales within one ulp, 2^-7 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config
from repro_torch.core.engines import EngineSpec
from repro_torch.serving import Request, ServeConfig, ServingEngine

from test_models_smoke import _batch_for
from test_torch_encdec import (_close, _t, frontend_models,
                               prefill_and_decode)
from torch_serving_pairs import one_cpu_thread  # noqa: F401 (autouse)

ARCH = "llava-next-mistral-7b-smoke"
FRONTEND_ARCHS = (ARCH, "seamless-m4t-large-v2-smoke")


def test_projector_matches_jax():
    """Image patches through the projector MLP, as the JAX
    ``_project_frontend``."""
    jmodel, jparams, tmodel = frontend_models(ARCH)
    emb = _batch_for(jax_get_config(ARCH), 2, 8)["frontend_embeds"]
    _close(tmodel._project_frontend(_t(emb)),
           jmodel._project_frontend(jparams, emb))


@pytest.mark.parametrize("kd", ["native", "int8"])
def test_prefill_and_decode_match_jax(kd):
    """16 image patches and 40 text tokens prefilled (56 > ``chunk_size``
    = 32, through the flash kernel's plain version), then 8 greedy
    ``decode_step``s: logits and every cache plane as JAX's."""
    tc = prefill_and_decode(ARCH, B=2, S=40, max_len=64, steps=8, kd=kd)
    assert tc["k"].shape[2] == 64 and int(tc["pos"][0]) == 56 + 8


def test_cache_is_never_cut():
    """A ``max_len`` below the image and text tokens pads to neither: the
    cache holds all 56 positions, as JAX's ``_pad_kv_to`` keeps them."""
    tc = prefill_and_decode(ARCH, B=2, S=40, max_len=48, steps=0)
    assert tc["k"].shape[2] == 56 and int(tc["pos"][0]) == 56


def test_decode_matches_full_forward():
    """``tests/test_models_smoke.py::test_decode_matches_full_forward`` on
    the port: prefill 64 tokens after the image, decode 8 more, and the
    last logits match a 72-token prefill (relative error below 2e-3);
    weights from JAX's ``init(PRNGKey(1))``, ``chunk_size=32``."""
    _, _, model = frontend_models(ARCH)
    B, S_total, S_pre = 2, 72, 64
    batch = _batch_for(jax_get_config(ARCH), B, S_total)
    toks, fe = _t(batch["tokens"]), _t(batch["frontend_embeds"])
    lg_full, _ = model.prefill(toks, 128, frontend_embeds=fe)
    lg, cache = model.prefill(toks[:, :S_pre], 128, frontend_embeds=fe)
    for t in range(S_pre, S_total):
        lg, cache = model.decode_step(cache, toks[:, t:t + 1], cache["pos"])
    ref, got = lg_full[:, 0].numpy(), lg[:, 0].numpy()
    rel = np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-9)
    assert rel < 2e-3, rel


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_prefill_without_frontend_embeds_is_refused(arch):
    """Both packages refuse a VLM or encoder-decoder prefill of tokens
    alone (the JAX ``prefill`` reads ``batch["frontend_embeds"]``), so
    neither serving engine serves these families: the port's
    ``generate()`` raises the same error."""
    jmodel, jparams, tmodel = frontend_models(arch)
    toks = np.zeros((1, 6), dtype=np.int32)
    with pytest.raises(KeyError, match="frontend_embeds"):
        jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)}, 16)
    with pytest.raises(ValueError, match="needs frontend_embeds"):
        tmodel.prefill(_t(toks), 16)
    eng = ServingEngine(tmodel, ServeConfig(
        max_len=16, page_tokens=4,
        engine_spec=EngineSpec(engine="paged", kv_hbm_bytes=1 << 20)),
        device="cpu")
    with pytest.raises(ValueError, match="needs frontend_embeds"):
        eng.generate([Request(rid=0, prompt=toks[0], max_new=2)])

