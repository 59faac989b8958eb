"""The FL stack of the port: small models, local training, the CFL and
GossipDFL baselines, the synchronous runner (``run_experiment``) and
the deadline-free FedBuff runner (``run_async_experiment``), beside the
JAX package's ``fl/``.  The runners train and aggregate in torch on the
GPU unless the caller passes ``device="cpu"``."""
from . import asyncfl, baselines, client, models_small, runner
from .asyncfl import AsyncConfig, AsyncResult, adversary_view, run_async_experiment
from .client import LocalSpec
from .runner import FLConfig, FLResult, run_experiment

__all__ = ["AsyncConfig", "AsyncResult", "FLConfig", "FLResult",
           "LocalSpec", "adversary_view", "run_async_experiment",
           "run_experiment", "asyncfl", "baselines", "client",
           "models_small", "runner"]
