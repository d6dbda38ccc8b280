"""Random weights of a DeepSeek-V2-style decoder (MLA attention, leading
dense layers, then routed and shared experts), drawn from ``--seed``.

As :mod:`perfbench.weights` does for the dense decoder: the program has
the weights written in place into its own parameter storage, and the
reference draws the same tensors again, one layer at a time. Each tensor
has a generator of its own (the same rule as the dense weights'), so any
tensor can be drawn alone. The experts are those of one chip's share:
``n_routed_experts`` held of the router's ``router_experts``, the router
keeping its whole width. Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

from perfbench.weights import DTYPES, fill_


class MoEArch:
    """The widths of a configuration file (Hugging Face key names of
    DeepSeek-V2's ``config.json``), as run on this chip: ``n_routed_experts``
    are the experts held here, from ``held_first_expert``, of the
    router's ``n_routed_experts_published``. A configuration the port's
    MoE decoder cannot run as stated raises."""

    def __init__(self, c: dict):
        self.name = c["name"]
        if c.get("hidden_act", "silu") != "silu":
            raise ValueError(f"{self.name}: the experts are SwiGLU")
        if c.get("scoring_func", "softmax") != "softmax":
            raise ValueError(f"{self.name}: the router scores by softmax")
        if int(c.get("moe_layer_freq", 1)) != 1:
            raise ValueError(f"{self.name}: every layer past the dense ones "
                             f"is an expert layer")
        self.L = int(c["num_hidden_layers"])
        self.d = int(c["hidden_size"])
        self.H = int(c["num_attention_heads"])
        self.F = int(c["intermediate_size"])
        self.V = int(c["vocab_size"])
        pad = int(c.get("vocab_pad_multiple", 256))
        self.Vp = -(-self.V // pad) * pad
        self.q_lora = int(c.get("q_lora_rank") or 0)
        self.dc = int(c["kv_lora_rank"])
        self.dn = int(c["qk_nope_head_dim"])
        self.dr = int(c["qk_rope_head_dim"])
        self.dv = int(c["v_head_dim"])
        self.n_dense = int(c["first_k_dense_replace"])
        self.E = int(c["n_routed_experts_published"])
        self.E_held = int(c["n_routed_experts"])
        self.first = int(c.get("held_first_expert", 0))
        if not 0 <= self.first <= self.E - self.E_held:
            raise ValueError(f"{self.name}: held experts {self.first}.."
                             f"{self.first + self.E_held - 1} of {self.E}")
        self.f = int(c["moe_intermediate_size"])
        self.n_shared = int(c["n_shared_experts"])
        self.top_k = int(c["num_experts_per_tok"])
        self.topk_method = c["topk_method"]
        self.n_group = int(c.get("n_group") or 1)
        self.topk_group = int(c.get("topk_group") or 1)
        self.norm_topk = bool(c["norm_topk_prob"])
        self.scale = float(c["routed_scaling_factor"])
        self.theta = float(c["rope_theta"])
        self.yarn = c.get("rope_scaling")
        if self.yarn is not None and self.yarn.get("type") != "yarn":
            raise ValueError(f"{self.name}: rope_scaling {self.yarn!r}")
        self.eps = float(c["rms_norm_eps"])
        self.tied = bool(c.get("tie_word_embeddings", False))
        self.dtype = DTYPES[c.get("torch_dtype", "bfloat16")]

    @property
    def n_moe(self) -> int:
        return self.L - self.n_dense

    def attn_matrices(self) -> dict:
        d, H, qk = self.d, self.H, self.dn + self.dr
        out = ({"w_dq": (d, self.q_lora), "w_uq": (self.q_lora, H * qk)}
               if self.q_lora else {"w_q": (d, H * qk)})
        out.update({"w_dkv": (d, self.dc), "w_kr": (d, self.dr),
                    "w_uk": (self.dc, H, self.dn),
                    "w_uv": (self.dc, H, self.dv),
                    "wo": (H * self.dv, d)})
        return out

    def moe_matrices(self) -> dict:
        d, f, E = self.d, self.f, self.E_held
        out = {"router": (d, self.E),
               "experts.w_gate": (E, d, f), "experts.w_up": (E, d, f),
               "experts.w_down": (E, f, d)}
        if self.n_shared:
            fs = f * self.n_shared
            out.update({"shared.w_gate": (d, fs), "shared.w_up": (d, fs),
                        "shared.w_down": (fs, d)})
        return out

    def dense_matrices(self) -> dict:
        return {"w_gate": (self.d, self.F), "w_up": (self.d, self.F),
                "w_down": (self.F, self.d)}


def _std(name: str, shape) -> float:
    """``1/sqrt(fan_in)``: the first axis of a matrix, the first axis of
    each expert's matrix for a stacked ``experts.*``."""
    return 1.0 / math.sqrt(shape[1] if name.startswith("experts.")
                           else shape[0])


def tensor_specs(a: MoEArch) -> list:
    """``(name, shape, std)`` of every weight, in draw order; ``std`` None
    marks a norm scale (all ones). Names are those of the port's
    ``LM.named_parameters()``."""
    specs = [("embed", (a.Vp, a.d), 1.0 / math.sqrt(a.Vp))]
    if not a.tied:
        specs.append(("head", (a.Vp, a.d), 1.0 / math.sqrt(a.Vp)))
    specs.append(("final_ln", (a.d,), None))
    for i in range(a.L):
        pre = f"blocks.{i}."
        specs += [(pre + "ln_attn", (a.d,), None),
                  (pre + "ln_ffn", (a.d,), None)]
        if a.q_lora:
            specs.append((pre + "q_norm", (a.q_lora,), None))
        specs.append((pre + "kv_norm", (a.dc,), None))
        mats = {**a.attn_matrices(), **(a.dense_matrices() if i < a.n_dense
                                        else a.moe_matrices())}
        specs += [(pre + n, shape, _std(n, shape))
                  for n, shape in mats.items()]
    return specs


def draw(a: MoEArch, seed: int, name: str, device, dtype=None):
    """Tensor ``name`` of ``seed`` in the served dtype (``dtype`` widens it
    after the draw)."""
    for i, (n, shape, std) in enumerate(tensor_specs(a)):
        if n == name:
            t = fill_(torch.empty(shape, dtype=a.dtype, device=device),
                      seed, i, std)
            return t if dtype is None else t.to(dtype)
    raise KeyError(name)


def draw_layer(a: MoEArch, seed: int, layer: int, device, dtype) -> dict:
    """Every tensor of decoder layer ``layer`` by its short name."""
    pre = f"blocks.{layer}."
    out = {}
    for i, (n, shape, std) in enumerate(tensor_specs(a)):
        if n.startswith(pre):
            t = fill_(torch.empty(shape, dtype=a.dtype, device=device),
                      seed, i, std)
            out[n[len(pre):]] = t.to(dtype)
            del t
    return out


@torch.no_grad()
def fill_module(module, a: MoEArch, seed: int) -> None:
    """Write every weight of ``seed`` in place into ``module``'s parameters
    of the same names; a missing name, a further parameter or another
    shape or dtype raises."""
    own = dict(module.named_parameters())
    specs = tensor_specs(a)
    if set(own) != {n for n, _, _ in specs}:
        raise ValueError(f"parameters differ from the weight list: "
                         f"{sorted(set(own) ^ {n for n, _, _ in specs})}")
    for i, (name, shape, std) in enumerate(specs):
        p = own[name]
        if tuple(p.shape) != shape or p.dtype != a.dtype:
            raise ValueError(f"{name}: {p.dtype}{list(p.shape)}, the "
                             f"weights are {a.dtype}{list(shape)}")
        fill_(p.data, seed, i, std)
