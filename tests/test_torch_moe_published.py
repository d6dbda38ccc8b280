"""DeepSeek-V2 as published, in the port: group-limited greedy routing,
one chip's held share of the experts, drop-free dispatch and YaRN.

* the routing (:func:`repro_torch.models.moe._select`) against a plain
  reading of ``group_limited_greedy``, token by token: the group mask,
  the top-k within it, no renormalisation, ×16;
* YaRN's inverse frequencies and MLA's softmax scale against the
  formulas of DeepSeek-V2's modelling code, at the published widths;
* the share: the 8 shares' outputs of one layer, the shared experts
  counted once, add up to the uncut layer's;
* padding: a drop-free layer routes only the valid slots, by the host's
  count (padding adds nothing to ``expert_rows``), and a token's output
  does not depend on its batch; the unfused decode steps route and count
  their real rows too;
* the grouped products (``torch._grouped_mm``, as an sm90 card runs them
  in bf16) against the ``bmm`` route, where this torch has them on the
  CPU;
* the serving engine's counters over a pooled fused run.

The JAX-mirror ``deepseek-v2-236b`` keeps its own tests, unchanged.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.engines.base import EngineSpec
from repro_torch.models import attention, layers
from repro_torch.models import moe as moe_mod
from repro_torch.models.model import LM
from repro_torch.serving.engine import Request, ServeConfig, ServingEngine

SMOKE = "deepseek-v2-236b-published-smoke"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**moe):
    cfg = get_config(SMOKE)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))


def _model(cfg, seed=0, dtype=torch.float32):
    return LM(cfg, dtype=dtype, device="cpu").init(
        torch.Generator().manual_seed(seed))


# ------------------------------------------------------------------ routing
def _plain_route(probs, m):
    """group_limited_greedy read plainly, one token at a time."""
    E = probs.shape[1]
    per = E // m.n_group
    ids, wts = [], []
    for s in probs.tolist():
        best = [max(s[g * per:(g + 1) * per]) for g in range(m.n_group)]
        groups = sorted(range(m.n_group), key=lambda g: (-best[g], g))
        kept = set(groups[:m.topk_group])
        cand = [(e, s[e]) for e in range(E) if e // per in kept]
        top = sorted(cand, key=lambda t: (-t[1], t[0]))[:m.top_k]
        ids.append([e for e, _ in top])
        wts.append([v * m.routed_scaling_factor for _, v in top])
    return ids, wts


@pytest.mark.parametrize("name", [SMOKE, "deepseek-v2-236b-published"])
def test_group_limited_routing_is_the_plain_reading(name):
    m = get_config(name).moe
    g = torch.Generator().manual_seed(3)
    probs = torch.softmax(torch.randn(64, m.num_experts, generator=g) * 2,
                          dim=-1)
    probs[0, :] = 1.0 / m.num_experts                # every score tied
    ids, w = moe_mod._select(probs, m)
    want_ids, want_w = _plain_route(probs, m)
    assert ids.tolist() == want_ids
    torch.testing.assert_close(w, torch.tensor(want_w), rtol=0, atol=0)
    # the weights are not renormalised: × 16 of the kept softmax scores
    assert (w.sum(-1) < m.routed_scaling_factor).all()
    per = m.num_experts // m.n_group
    assert all(len({e // per for e in row}) <= m.topk_group
               for row in ids.tolist())


def test_greedy_defaults_renormalise_as_before():
    m = get_config("deepseek-v2-236b").moe
    probs = torch.softmax(torch.randn(16, m.num_experts), dim=-1)
    ids, w = moe_mod._select(probs, m)
    top_w, top_ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    assert torch.equal(ids, top_ids[:, :m.top_k])
    assert torch.equal(w, top_w[:, :m.top_k]
                       / top_w[:, :m.top_k].sum(-1, keepdim=True))


# --------------------------------------------------------------------- YaRN
def test_yarn_frequencies_and_scale_are_the_formulas():
    cfg = get_config("deepseek-v2-236b-published")
    y, dr = cfg.rope_scaling, cfg.mla.qk_rope_head_dim

    def dim(r):
        return dr * math.log(4096 / (2 * math.pi * r)) / (2 * math.log(1e4))
    low, high = max(math.floor(dim(32)), 0), min(math.ceil(dim(1)), dr - 1)
    assert (low, high) == (10, 23)
    want = []
    for i in range(dr // 2):
        mask = 1 - min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(1e4 ** (-2 * i / dr) * (mask + (1 - mask) / 40))
    got = layers.yarn_frequencies(dr, cfg.rope_theta, y)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, torch.tensor(want, dtype=torch.float32),
                               rtol=1e-7, atol=0)
    mscale = 0.1 * 0.707 * math.log(40) + 1
    assert attention._mla_scale(cfg) == pytest.approx(
        192 ** -0.5 * mscale ** 2, rel=1e-12)
    assert mscale ** 2 == pytest.approx(1.590, abs=1e-3)
    # cos and sin scaled by mscale(40, 0.707) / mscale(40, 0.707) = 1:
    # the rotation keeps a vector's norm
    x = torch.randn(5, 3, dr)
    out = layers.apply_rope(x, torch.arange(5) * 1000, cfg.rope_theta, y)
    torch.testing.assert_close(out.norm(dim=-1), x.norm(dim=-1))
    # and the mirror has no YaRN: its scale and table are as before
    mirror = get_config("deepseek-v2-236b")
    assert attention._mla_scale(mirror) == 1 / math.sqrt(192)


# -------------------------------------------------------------------- share
def _layer(model):
    return model.blocks[model.cfg.moe.first_k_dense]


def test_the_eight_shares_add_up_to_the_uncut_layer():
    """Each share holds 2 of 16 experts; summed with the shared experts
    counted once, the shares give the uncut layer (fp64: the sums differ
    only in their order)."""
    full = _cfg()
    m = full.moe
    whole = _model(full).double()
    p = _layer(whole)
    x = torch.randn(2, 7, full.d_model, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5))
    want, _ = moe_mod.apply_moe(p, full, x)
    held = 2
    shared = moe_mod.apply_ffn(p.shared, x.reshape(-1, full.d_model),
                               full.ffn_activation).reshape(x.shape)
    total = shared.clone()
    for s in range(m.num_experts // held):
        cut = dataclasses.replace(full, moe=dataclasses.replace(
            m, first_held=s * held, num_held=held))
        part = _model(cut).double()
        q = _layer(part)
        q.load_state_dict({k: v for k, v in p.state_dict().items()
                           if not k.startswith("experts.")}, strict=False)
        for n in ("w_gate", "w_up", "w_down"):
            getattr(q.experts, n).data.copy_(
                getattr(p.experts, n)[s * held:(s + 1) * held])
        y, _ = moe_mod.apply_moe(q, cut, x)
        total += y - shared
    torch.testing.assert_close(total, want, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------------ padding
def test_padding_is_not_routed_and_a_token_keeps_its_output():
    cfg = _cfg(first_held=4, num_held=4)
    model = _model(cfg, seed=1)
    p = _layer(model)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(3, 8, cfg.d_model, generator=g)
    q_lens = torch.tensor([8, 3, 0])
    valid = torch.arange(8)[None, :] < q_lens[:, None]
    route = moe_mod.Route(valid, 11, [])
    y, aux = moe_mod.apply_moe(p, cfg, x, route=route)
    assert aux is None                 # serving never computes the aux loss
    rows, run, routed = moe_mod.tally(route).tolist()
    assert routed == 11
    alone = []
    for b, ql in enumerate(q_lens.tolist()):
        if ql:
            one = moe_mod.Route(None, ql, [])
            ya, _ = moe_mod.apply_moe(p, cfg, x[b:b + 1, :ql], route=one)
            alone.append((ya[0], moe_mod.tally(one)[0]))
    assert rows == sum(int(r) for _, r in alone)
    for b, (ya, _) in enumerate(alone):
        torch.testing.assert_close(y[b, :q_lens[b]], ya, rtol=1e-5,
                                   atol=1e-6)
    # a slot not routed gets 0, the shared experts' share included
    assert torch.equal(y[2], torch.zeros_like(x[2]))
    with pytest.raises(ValueError, match="n_valid"):
        moe_mod.apply_moe(p, cfg, x, route=moe_mod.Route(valid, None, []))


def _pool_cache(model, cfg, B, P=16, T=4, MP=4):
    """An empty page pool for ``B`` rows of ``MP`` pages each."""
    cache = {"block_table": torch.arange(B * MP, dtype=torch.int32)
             .view(B, MP) % P}
    for pl in model.cache_descriptor(T).paged_planes:
        cache["pool_" + pl.name] = torch.zeros(
            (cfg.num_layers, P, T) + tuple(pl.shape), dtype=pl.torch_dtype)
    return cache


def test_decode_steps_route_their_rows_and_tally_them():
    """The unfused decode steps hand their MoE layers a route as the fused
    step does: ``decode_step_paged`` every row, ``decode_step`` the first
    ``n_valid`` (the rest padding, as the mirror's power-of-two ladder
    pads), so neither computes the aux loss and the engine counts both."""
    cfg = _cfg(first_held=0, num_held=8)
    model = _model(cfg, seed=3)
    n_moe = cfg.num_layers - cfg.moe.first_k_dense
    g = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (3, 1), generator=g)
    pos = torch.tensor([0, 2, 5], dtype=torch.int32)
    model.decode_step_paged(_pool_cache(model, cfg, 3), tokens, pos)
    rows, run, routed = model.moe_tally.tolist()
    assert routed == n_moe * 3
    assert 0 < rows <= routed * cfg.moe.top_k and 0 < run
    prompts = torch.randint(0, cfg.vocab_size, (3, 2), generator=g)
    _, cache = model.prefill(prompts, 16)
    full, _ = model.decode_step(dict(cache), tokens, cache["pos"])
    full_tally = model.moe_tally.tolist()
    assert full_tally[2] == n_moe * 3
    part, _ = model.decode_step(dict(cache), tokens, cache["pos"], n_valid=2)
    assert model.moe_tally.tolist()[2] == n_moe * 2
    assert model.moe_tally.tolist()[0] < full_tally[0]
    torch.testing.assert_close(part[:2], full[:2], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fuse", [False, True])
def test_the_engine_routes_every_token_it_feeds(fuse):
    """Unfused (``decode_step_paged`` for each chunk token, the ragged step
    at ``q_len`` 1 for decode) and fused alike, every token the engine
    feeds is routed and counted once: each prompt token and each generated
    one, the last included (the engine steps it before it sees the row
    done)."""
    cfg = _cfg(first_held=0, num_held=8)
    model = _model(cfg, seed=7)
    eng = ServingEngine(model, ServeConfig(
        max_len=64, page_tokens=4, max_batch_seqs=4, prefill_chunk_tokens=5,
        fuse_ticks=fuse, paged_decode=True,
        engine_spec=EngineSpec(engine="paged", kv_hbm_bytes=64 << 20)),
        device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new=4)
            for i, n in enumerate((8, 12, 3))]
    eng.generate(reqs)
    s = eng.stats()
    n_moe = cfg.num_layers - cfg.moe.first_k_dense
    fed = sum(len(r.prompt) + len(r.generated) for r in reqs)
    assert s["routed_slots"] == n_moe * fed
    assert 0 < s["expert_rows"] <= s["routed_slots"] * cfg.moe.top_k


def test_grouped_products_match_the_bmm_route(monkeypatch):
    """``torch._grouped_mm`` over the sorted rows (the route an sm90 card
    takes in bf16) against the per-expert ``bmm``, bf16 on the CPU, where
    this torch runs it."""
    if not hasattr(torch, "_grouped_mm"):
        pytest.skip("this torch has no _grouped_mm")
    cfg = _cfg(first_held=2, num_held=8)
    p = _layer(_model(cfg, seed=4, dtype=torch.bfloat16))
    x = torch.randn(1, 40, cfg.d_model,
                    generator=torch.Generator().manual_seed(6)).bfloat16()
    try:
        torch._grouped_mm(x[0, :4], p.experts.w_gate[:1],
                          offs=torch.tensor([4], dtype=torch.int32))
    except (RuntimeError, NotImplementedError) as e:
        pytest.skip(f"no CPU _grouped_mm here: {e}")
    base, _ = moe_mod.apply_moe(p, cfg, x, route=moe_mod.Route(None, 40, []))
    monkeypatch.setattr(moe_mod, "_grouped", lambda rows, experts: True)
    route = moe_mod.Route(None, 40, [])
    grouped, _ = moe_mod.apply_moe(p, cfg, x, route=route)
    assert int(moe_mod.tally(route)[0]) > 0
    torch.testing.assert_close(grouped.float(), base.float(), rtol=2e-2,
                               atol=2e-2)


# ------------------------------------------------------------------ engine
def test_engine_counts_the_real_slots_and_the_rows():
    cfg = _cfg(first_held=0, num_held=8)
    model = _model(cfg, seed=7)
    eng = ServingEngine(model, ServeConfig(
        max_len=64, page_tokens=4, max_batch_seqs=4, prefill_chunk_tokens=5,
        fuse_ticks=True, paged_decode=True,
        engine_spec=EngineSpec(engine="paged", kv_hbm_bytes=64 << 20)),
        device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new=5)
            for i, n in enumerate((8, 12, 3))]
    eng.generate(reqs)
    s = eng.stats()
    prefilled = sum(min(len(r.prompt), 5) for r in reqs)
    n_moe = cfg.num_layers - cfg.moe.first_k_dense
    assert s["routed_slots"] == n_moe * (s["step_tokens"] + prefilled)
    assert s["step_slots"] > s["step_tokens"]
    assert 0 < s["expert_rows"] <= s["routed_slots"] * cfg.moe.top_k
    assert 0 < s["experts_run"] <= n_moe * 8 * (s["prefill_calls"]
                                                + s["step_calls"])
    assert all(isinstance(v, int) for v in s.values()
               if not isinstance(v, float))
