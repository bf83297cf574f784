from .common import ArchConfig
from .convert import params_from_numpy
from .model import build_model
from .transformer import TransformerLM

__all__ = ["ArchConfig", "TransformerLM", "build_model", "params_from_numpy"]
