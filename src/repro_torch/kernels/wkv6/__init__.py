from . import ops, ref
from .wkv6 import wkv6_cuda
