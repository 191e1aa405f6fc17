"""Serving: the LM continuous-batching engine (``ServeEngine``).  The
SpTRSV ``SolveEngine`` comes with ROADMAP A9."""
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
