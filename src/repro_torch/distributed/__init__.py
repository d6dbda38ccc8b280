"""Distribution layer of the port: gradient compression with error feedback
(``compression``). Sharding, the mesh and the dry run are not ported yet."""
from repro_torch.distributed.compression import (
    dequantize_int8, make_error_feedback_compressor, quantize_int8)

__all__ = ["quantize_int8", "dequantize_int8",
           "make_error_feedback_compressor"]
