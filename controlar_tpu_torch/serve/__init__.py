"""Continuous-batching serving: `engine.ServeEngine`."""
from controlar_tpu_torch.serve.engine import Request, ServeConfig, ServeEngine

__all__ = ["Request", "ServeConfig", "ServeEngine"]
