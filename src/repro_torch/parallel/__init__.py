from .collectives import (
    ErrorFeedback,
    compressed_grad_tree,
    compressed_psum,
    dequantize_int8,
    quantize_int8,
)
from .sharding import P, gather_shards, serving_tp_shards

__all__ = ["ErrorFeedback", "P", "compressed_grad_tree", "compressed_psum",
           "dequantize_int8", "gather_shards", "quantize_int8",
           "serving_tp_shards"]
