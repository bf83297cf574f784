from . import ops, ref
from .segment_zero import segment_zero_cuda
