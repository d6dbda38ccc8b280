"""Distribution layer of the port: the reference's sharding rules as
DTensor placements (``sharding``) and gradient compression with error
feedback (``compression``)."""
from repro_torch.distributed.compression import (
    dequantize_int8, make_error_feedback_compressor, quantize_int8)
from repro_torch.distributed.sharding import (P, batch_specs, cache_specs,
                                              data_axes, distribute,
                                              param_specs, to_placements,
                                              zero1_specs)

__all__ = ["P", "batch_specs", "cache_specs", "data_axes", "distribute",
           "param_specs", "to_placements", "zero1_specs", "quantize_int8",
           "dequantize_int8", "make_error_feedback_compressor"]
