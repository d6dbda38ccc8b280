"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``ref.py``) and a dispatching wrapper (``ops.py``): the same
twelve public entries as the JAX package's ``repro.kernels``.

``ENTRIES`` holds those twelve entries. ``COUNTED`` holds them and
``kv_page_write``, the paged steps' K/V write into the pool, which has no
JAX counterpart (XLA scatters there): each counts its kernel launches in
``<entry>.launches``, and :func:`reset_launch_counts` sets them all to 0.
"""
from repro_torch.kernels.flash_attention import ops as _flash_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.log_patch import ops as _log_patch_ops
from repro_torch.kernels.log_patch.ops import log_patch
from repro_torch.kernels.paged_attention import ops as _paged_ops
from repro_torch.kernels.paged_attention.ops import (
    kv_page_write, mla_paged_attention, mla_paged_attention_layers_ragged,
    mla_paged_attention_ragged, paged_attention, paged_attention_layers,
    paged_attention_layers_ragged, paged_attention_layers_ragged_q8,
    paged_attention_q8, paged_attention_ragged, paged_attention_ragged_q8)

__all__ = ["flash_attention", "paged_attention", "paged_attention_layers",
           "paged_attention_ragged", "paged_attention_layers_ragged",
           "paged_attention_q8", "paged_attention_ragged_q8",
           "paged_attention_layers_ragged_q8",
           "mla_paged_attention", "mla_paged_attention_ragged",
           "mla_paged_attention_layers_ragged",
           "log_patch"]

_MODULES = (_paged_ops, _flash_ops, _log_patch_ops)
ENTRIES = tuple(e for m in _MODULES for e in m.ENTRIES)
COUNTED = ENTRIES + (kv_page_write,)


def reset_launch_counts() -> None:
    for m in _MODULES:
        m.reset_launch_counts()
