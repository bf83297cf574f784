from . import ops, ref
from .flash_attention import flash_attention_cuda
