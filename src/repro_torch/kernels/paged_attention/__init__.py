from . import ops, ref
from .paged_attention import paged_attention_cuda
