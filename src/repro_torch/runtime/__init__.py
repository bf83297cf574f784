from .fault import (FailureInjector, HeartbeatMonitor, StragglerDetector,
                    WorkerFailure)
from .sampling import sample_token, sampler_method
from .serve_loop import Request, Server, ServerConfig, ServingEngine
from .train_loop import Trainer, TrainerConfig, TrainStepper

__all__ = ["FailureInjector", "HeartbeatMonitor", "Request", "Server",
           "ServerConfig", "ServingEngine", "StragglerDetector", "Trainer",
           "TrainerConfig", "TrainStepper", "WorkerFailure", "sample_token",
           "sampler_method"]
