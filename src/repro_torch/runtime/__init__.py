from .sampling import sample_token, sampler_method
from .serve_loop import Request, ServerConfig, ServingEngine

__all__ = ["Request", "ServerConfig", "ServingEngine", "sample_token",
           "sampler_method"]
