from .pipeline import DataConfig, FileBackedLM, Loader, SyntheticLM
from .tokenizer import ByteTokenizer

__all__ = ["ByteTokenizer", "DataConfig", "FileBackedLM", "Loader", "SyntheticLM"]
