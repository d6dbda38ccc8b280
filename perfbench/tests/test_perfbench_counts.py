"""The yardstick's counts, against values worked out by hand."""
import pytest

from perfbench import counts
from perfbench.weights import Arch

TINY = {"name": "t", "num_hidden_layers": 2, "hidden_size": 4,
        "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 2,
        "intermediate_size": 8, "hidden_act": "silu", "vocab_size": 10,
        "rope_theta": 1e4, "rms_norm_eps": 1e-5}


def test_causal_pairs_by_hand():
    assert counts.causal_pairs(3, 3) == 1 + 2 + 3
    assert counts.causal_pairs(2, 5) == 4 + 5       # the last 2 of 5
    assert counts.causal_pairs(3, 4, causal=False) == 12


def test_flash_work_by_hand():
    # B 1, S 3, H 2, K 1, D 2: bytes (q 3*2*2 + k 3*2 + v 3*2 + o 3*2*2) * 2
    nbytes, flops = counts.flash_work(1, 3, 3, 2, 1, 2, 2)
    assert nbytes == (12 + 6 + 6 + 12) * 2
    assert flops == 2 * (2 + 2) * 2 * 6


def test_paged_work_by_hand():
    # one decode row of 17 tokens (2 pages of 16), one 3-token chunk row
    # of 5 tokens (1 page); H 2, K 1, D 2, bf16
    nbytes, flops = counts.paged_work([(17, 1), (5, 3), (9, 0)], 16, 2, 1, 2)
    page = 16 * 1 * 2 * 2 * 2
    assert nbytes == 2 * page + 2 * 1 * 2 * 2 * 2 + page + 2 * 3 * 2 * 2 * 2
    assert flops == 4 * 2 * 2 * (17 + (3 + 4 + 5))


def test_model_flops_by_hand():
    a = Arch(TINY)
    per_layer = 4 * 4 + 4 * 2 + 4 * 2 + 4 * 4 + 3 * 4 * 8
    assert counts.layer_matmul_params(a) == per_layer
    # 2 tokens at positions 1, 2 (pairs 2 + 3), one through the head
    assert counts.span_flops(a, 1, 2, 1) == (
        2 * 2 * 2 * per_layer + 4 * 2 * 2 * 2 * 5 + 2 * 10 * 4)
    assert counts.train_step_flops(a, 1, 2) == 3 * (
        2 * 2 * 2 * per_layer + 4 * 2 * 2 * 2 * 3 + 2 * 2 * 10 * 4)


def test_bound_is_the_larger_term():
    assert counts.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 989e12) == pytest.approx(1.0)
    assert counts.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)
