"""Server: state, queues, applier, workers (a server that only
schedules; the leader services are ROADMAP A9b)."""

from .server import Server, ServerConfig
from .worker import Worker

__all__ = ["Server", "ServerConfig", "Worker"]
