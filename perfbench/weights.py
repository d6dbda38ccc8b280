"""Random weights of a dense GQA decoder, drawn from ``--seed``.

Both sides take their weights from here: the program has them written in
place into its own parameter storage, and the reference draws the same
tensors again (in the served dtype, then widened to fp32), one layer at a
time if it likes. Each tensor has a generator of its own, seeded from the
run's seed and the tensor's index in :func:`tensor_specs`, so any tensor
can be drawn alone. Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


class Arch:
    """The widths of a configuration file (Hugging Face key names), as
    run: the file's ``departures`` (where the port's decoder departs from
    the published model) over its published values. A configuration the
    port's dense decoder cannot run as stated raises."""

    def __init__(self, c: dict):
        c = {**c, **c.get("departures", {})}
        if c.get("use_bias", c.get("bias", False)):
            raise ValueError(f"{c['name']}: the port's decoder has no bias "
                             f"terms; state use_bias false under departures")
        if c.get("norm_type", "rms_norm") != "rms_norm":
            raise ValueError(f"{c['name']}: the port's decoder norms with "
                             f"RMSNorm; state norm_type under departures")
        self.name = c["name"]
        self.L = int(c["num_hidden_layers"])
        self.d = int(c["hidden_size"])
        self.H = int(c["num_attention_heads"])
        self.K = int(c["num_key_value_heads"])
        self.D = int(c.get("head_dim") or self.d // self.H)
        self.F = int(c["intermediate_size"])
        self.V = int(c["vocab_size"])
        pad = int(c.get("vocab_pad_multiple", 256))
        self.Vp = -(-self.V // pad) * pad
        act = c["hidden_act"]
        if act not in ("silu", "gelu_pytorch_tanh"):
            raise ValueError(f"{self.name}: hidden_act {act!r} is neither "
                             f"silu (SwiGLU) nor gelu_pytorch_tanh")
        self.gated = act == "silu"
        self.theta = float(c["rope_theta"])
        self.eps = float(c.get("rms_norm_eps", c.get("norm_epsilon", 1e-5)))
        self.tied = bool(c.get("tie_word_embeddings", False))
        self.dtype = DTYPES[c.get("torch_dtype", "bfloat16")]

    def layer_matrices(self) -> dict:
        d, q, kv, F = self.d, self.H * self.D, self.K * self.D, self.F
        out = {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d)}
        if self.gated:
            out["w_gate"] = (d, F)
        out.update({"w_up": (d, F), "w_down": (F, d)})
        return out


def tensor_specs(a: Arch) -> list:
    """``(name, shape, std)`` of every weight, in draw order; ``std`` None
    marks a norm scale (all ones). Names are those of the port's
    ``LM.named_parameters()``."""
    specs = [("embed", (a.Vp, a.d), 1.0 / math.sqrt(a.Vp))]
    if not a.tied:
        specs.append(("head", (a.Vp, a.d), 1.0 / math.sqrt(a.Vp)))
    specs.append(("final_ln", (a.d,), None))
    for i in range(a.L):
        specs += [(f"blocks.{i}.ln_attn", (a.d,), None),
                  (f"blocks.{i}.ln_ffn", (a.d,), None)]
        specs += [(f"blocks.{i}.{n}", shape, 1.0 / math.sqrt(shape[0]))
                  for n, shape in a.layer_matrices().items()]
    return specs


def _tensor_seed(seed: int, index: int) -> int:
    return (int(seed) * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) \
        % (2 ** 63 - 1)


@torch.no_grad()
def fill_(t: torch.Tensor, seed: int, index: int, std) -> torch.Tensor:
    """Draw tensor ``index`` of ``seed`` into ``t`` in place, in ``t``'s
    dtype, on ``t``'s device."""
    if std is None:
        return t.fill_(1.0)
    g = torch.Generator(device=t.device)
    g.manual_seed(_tensor_seed(seed, index))
    t.normal_(0.0, std, generator=g)
    return t.clamp_(-2.0 * std, 2.0 * std)


def draw(a: Arch, seed: int, name: str, device, dtype=None) -> torch.Tensor:
    """Tensor ``name`` of ``seed`` in the served dtype (``dtype`` widens it
    after the draw)."""
    for i, (n, shape, std) in enumerate(tensor_specs(a)):
        if n == name:
            t = fill_(torch.empty(shape, dtype=a.dtype, device=device),
                      seed, i, std)
            return t if dtype is None else t.to(dtype)
    raise KeyError(name)


def draw_layer(a: Arch, seed: int, layer: int, device, dtype) -> dict:
    """Every tensor of decoder layer ``layer`` by its short name."""
    pre = f"blocks.{layer}."
    return {n[len(pre):]: draw(a, seed, n, device, dtype)
            for n, _, _ in tensor_specs(a) if n.startswith(pre)}


@torch.no_grad()
def fill_module(module, a: Arch, seed: int) -> None:
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
