"""Serving: the micro-batching engine and its stdlib HTTP front end
(``engine.py``, ``server.py``)."""

from .engine import EngineMisconfigured, EngineUnavailable, InferenceEngine, ServeConfig
from .server import make_server, serve_forever_in_thread

__all__ = ["EngineMisconfigured", "EngineUnavailable", "InferenceEngine", "ServeConfig", "make_server",
           "serve_forever_in_thread"]
