from .common import ArchConfig
from .convert import params_from_numpy
from .model import build_model
from .rwkv import RwkvLM
from .transformer import TransformerLM

__all__ = ["ArchConfig", "RwkvLM", "TransformerLM", "build_model",
           "params_from_numpy"]
