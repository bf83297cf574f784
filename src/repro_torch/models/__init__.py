from .common import ArchConfig
from .convert import params_from_numpy
from .encdec import EncDecLM
from .hybrid import HybridLM
from .model import build_model
from .rwkv import RwkvLM
from .transformer import TransformerLM

__all__ = ["ArchConfig", "EncDecLM", "HybridLM", "RwkvLM", "TransformerLM",
           "build_model", "params_from_numpy"]
