from .sampling import sample_token, sampler_method
from .serve_loop import Request, Server, ServerConfig, ServingEngine

__all__ = ["Request", "Server", "ServerConfig", "ServingEngine",
           "sample_token", "sampler_method"]
