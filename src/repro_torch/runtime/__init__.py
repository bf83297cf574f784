from .elastic import (ElasticAutoscaler, ElasticController, ElasticEvent,
                      ScaleDecision, plan_mesh)
from .fault import (FailureInjector, HeartbeatMonitor, StragglerDetector,
                    WorkerFailure)
from .orchestrator import (BatchJob, OrchestratorConfig, WorkloadOrchestrator)
from .replica import ReplicaSet
from .sampling import sample_token, sampler_method
from .serve_loop import Request, Server, ServerConfig, ServingEngine
from .train_loop import Trainer, TrainerConfig, TrainStepper

__all__ = ["BatchJob", "ElasticAutoscaler", "ElasticController",
           "ElasticEvent", "FailureInjector", "HeartbeatMonitor",
           "OrchestratorConfig", "ReplicaSet", "Request", "ScaleDecision",
           "Server", "ServerConfig", "ServingEngine", "StragglerDetector",
           "Trainer", "TrainerConfig", "TrainStepper", "WorkerFailure",
           "WorkloadOrchestrator", "plan_mesh", "sample_token",
           "sampler_method"]
