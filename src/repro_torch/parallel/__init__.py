from .collectives import (
    ErrorFeedback,
    compressed_grad_tree,
    compressed_psum,
    dequantize_int8,
    quantize_int8,
)
from .sharding import (
    AbstractMesh,
    NamedSharding,
    P,
    batch_shardings,
    batch_specs,
    decode_state_shardings,
    gather_shards,
    named,
    opt_state_shardings,
    param_shardings,
    param_spec,
    serving_tp_shards,
)

__all__ = ["AbstractMesh", "ErrorFeedback", "NamedSharding", "P",
           "batch_shardings", "batch_specs", "compressed_grad_tree",
           "compressed_psum", "decode_state_shardings", "dequantize_int8",
           "gather_shards", "named", "opt_state_shardings",
           "param_shardings", "param_spec", "quantize_int8",
           "serving_tp_shards"]
