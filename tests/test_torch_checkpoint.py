"""The port's ``CheckpointManager`` over its FS tier: the scenarios of
``tests/test_checkpoint.py`` without its JAX training loop.

* bit-exact resume after ``crash()`` on ``paged``, ``log`` and
  ``nvhybrid``: the ``internlm2-1.8b-smoke`` weights of JAX's ``LM.init``
  (``params_from_jax``), fp32 and bf16, restored into a model drawn from
  another seed, tensor for tensor and logit for logit;
* delta saves on ``log`` cost fewer simulated seconds;
* restore after several saves, the argument errors, and a restore with
  nothing saved;
* a flat fp32/int32 dict in sorted-key order (where both packages name
  the leaves alike) through both packages' managers: equal ``fs.stats()``
  and simulated seconds, and the same arrays back.
"""
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import EngineSpec, NVCacheFS
from repro_torch.core.ckpt_backend import (LogCheckpointBackend,
                                           PagedCheckpointBackend)
from repro_torch.models import LM

from torch_serving_pairs import arch_models
from torch_serving_pairs import one_cpu_thread  # noqa: F401 (autouse)

ARCH = "internlm2-1.8b-smoke"
DESIGNS = ("paged", "log", "nvhybrid")


def _model(dtype, seed=None):
    """The JAX ``LM.init`` weights in the port's ``LM`` (cast to
    ``dtype``), or, with ``seed``, a model drawn from that seed."""
    _, _, ref = arch_models(ARCH)
    model = LM(ref.cfg, dtype=dtype, device="cpu")
    if seed is None:
        model.load_state_dict(ref.state_dict())
    else:
        model.init(torch.Generator().manual_seed(seed))
    return model


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def _logits(model):
    toks = torch.tensor(np.random.default_rng(3).integers(0, 512, (2, 9)))
    return model.prefill(toks, 16)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("design", DESIGNS)
def test_bit_exact_resume_after_crash(design, dtype):
    saved = _model(dtype)
    mgr = CheckpointManager(design, nvmm_bytes=256 << 20)
    mgr.save(3, saved.state_dict())
    mgr.crash()
    other = _model(dtype, seed=11)
    like = other.state_dict()
    assert not all(_same_bits(a, b) for a, b in zip(
        like.values(), saved.state_dict().values()))
    step, restored = mgr.restore(like)
    assert step == 3 and list(restored) == list(like)
    for k, t in saved.state_dict().items():
        assert _same_bits(restored[k], t), k
        assert restored[k].device == like[k].device
    other.load_state_dict(restored)
    assert torch.equal(_logits(other), _logits(saved))


def test_log_design_delta_saves_are_cheaper():
    state = _model(torch.float32).state_dict()
    log_mgr = CheckpointManager("log", nvmm_bytes=512 << 20,
                                snapshot_every=100)
    paged_mgr = CheckpointManager("paged", nvmm_bytes=512 << 20)
    t_full_log = log_mgr.save(1, state)
    t_paged = paged_mgr.save(1, state)
    t_delta = log_mgr.save(2, state, changed={"leaf0"})
    assert t_delta < 0.25 * t_full_log
    assert t_delta < 0.25 * t_paged


@pytest.mark.parametrize("design", ["paged", "log"])
def test_restore_after_multiple_saves(design):
    """Four saves (the log design cuts a snapshot every second one), each
    of a changed state; the restore is the last."""
    state = _model(torch.float32).state_dict()
    mgr = CheckpointManager(design, nvmm_bytes=512 << 20, snapshot_every=2)
    for s in range(1, 5):
        state = {k: v + s if v.is_floating_point() else v
                 for k, v in state.items()}
        mgr.save(s, state)
    step, restored = mgr.restore({k: torch.empty_like(v)
                                  for k, v in state.items()})
    assert step == 4
    for k, v in state.items():
        assert _same_bits(restored[k], v), k


def test_nested_tree_and_its_leaf_order():
    """Leaves are named in the mapping's own order, depth first; the
    restore rebuilds ``like``'s structure."""
    tree = {"b": torch.arange(3, dtype=torch.int32),
            "a": {"y": torch.ones(2, 2, dtype=torch.bfloat16),
                  "x": {"s": torch.tensor(2.5), "e": torch.zeros(0)}}}
    mgr = CheckpointManager("paged", nvmm_bytes=1 << 20)
    mgr.save(7, tree)
    raw = mgr.backend.restore()[1]
    assert raw["leaf0"] == tree["b"].numpy().tobytes()
    assert raw["leaf1"] == tree["a"]["y"].view(torch.int16).numpy().tobytes()
    mgr.crash()
    like = {"b": torch.zeros(3, dtype=torch.int32),
            "a": {"y": torch.zeros(2, 2, dtype=torch.bfloat16),
                  "x": {"s": torch.tensor(0.0), "e": torch.ones(0)}}}
    step, out = mgr.restore(like)
    assert step == 7 and list(out) == ["b", "a"]
    assert list(out["a"]) == ["y", "x"] and list(out["a"]["x"]) == ["s", "e"]
    assert torch.equal(out["b"], tree["b"])
    assert _same_bits(out["a"]["y"], tree["a"]["y"])
    assert _same_bits(out["a"]["x"]["s"], tree["a"]["x"]["s"])
    assert out["a"]["x"]["e"].shape == (0,)
    out["b"].add_(1)                  # the restore owns its memory
    assert torch.equal(mgr.restore(like)[1]["b"], tree["b"])
    with pytest.raises(ValueError, match="leaf1"):
        mgr.restore({**like, "a": {**like["a"], "y": torch.zeros(2, 2)}})
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"b": like["b"]})
    with pytest.raises(TypeError, match="mapping of tensors"):
        mgr.save(8, {"b": [tree["b"]]})


def test_design_arg_picks_backend_even_with_explicit_fs():
    fs = NVCacheFS("nvpages", nvmm_bytes=16 << 20)
    mgr = CheckpointManager("log", fs=fs)
    assert isinstance(mgr.backend, LogCheckpointBackend)
    assert mgr.design == "log" and mgr.fs is fs
    mgr = CheckpointManager("nvhybrid", fs=fs)
    assert isinstance(mgr.backend, PagedCheckpointBackend)
    with pytest.raises(ValueError, match="unknown cache engine"):
        CheckpointManager("lgo", fs=fs)
    with pytest.raises(TypeError, match="inside the EngineSpec"):
        CheckpointManager(nvmm_bytes=1 << 28,
                          spec=EngineSpec(engine="nvlog"))
    with pytest.raises(TypeError, match="either design or spec"):
        CheckpointManager("paged", spec=EngineSpec(engine="nvlog"))
    with pytest.raises(TypeError, match="explicit fs"):
        CheckpointManager("log", nvmm_bytes=16 << 20, fs=fs)
    # the port's spec default is its KV engine: the FS registry says so
    with pytest.raises(ValueError, match="KV engine registry"):
        CheckpointManager(spec=EngineSpec())


@pytest.mark.parametrize("design", DESIGNS)
def test_restore_before_any_save_raises(design):
    mgr = CheckpointManager(design, nvmm_bytes=1 << 20)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        mgr.restore({"a": torch.zeros(1)})
    mgr.crash()
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        mgr.restore({"a": torch.zeros(1)})


def _flat(seed):
    rng = np.random.default_rng(seed)
    arrays = {"bias": rng.standard_normal(37).astype(np.float32),
              "count": rng.integers(-9, 9, (5, 3)).astype(np.int32),
              "w": rng.standard_normal((300, 41)).astype(np.float32),
              "zz": np.float32(rng.standard_normal())}
    return dict(sorted(arrays.items()))


@pytest.mark.parametrize("design", DESIGNS)
def test_flat_dict_through_both_managers(design):
    """Sorted keys: both packages name the leaves alike, write the same
    bytes and meta, and so charge the same simulated seconds."""
    arrays = [_flat(0), _flat(1)]
    jmgr = JaxCheckpointManager(design, nvmm_bytes=1 << 20,
                                snapshot_every=2)
    mgr = CheckpointManager(design, nvmm_bytes=1 << 20, snapshot_every=2)
    for step, a in enumerate(arrays, 1):
        changed = {"leaf2"} if step == 2 else None
        t_jax = jmgr.save(step, a, changed=changed)
        t = mgr.save(step, {k: torch.from_numpy(np.array(v))
                            for k, v in a.items()}, changed=changed)
        assert t == t_jax
        assert mgr.fs.stats() == jmgr.fs.stats()
    for m in (jmgr, mgr):
        m.crash()
    jstep, jout = jmgr.restore(arrays[0])
    step, out = mgr.restore({k: torch.zeros(np.shape(v), dtype=getattr(
        torch, np.asarray(v).dtype.name)) for k, v in arrays[0].items()})
    assert step == jstep == 2
    assert mgr.fs.stats() == jmgr.fs.stats()
    assert mgr.fs.simulated_time == jmgr.fs.simulated_time
    for k in arrays[0]:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
