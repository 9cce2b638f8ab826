"""Server: state, queues, applier, workers, and the leader services
(admission, heartbeats, drainer, deployment watcher, periodic dispatch,
core GC, volume watcher, ACL, defrag)."""

from .server import Server, ServerConfig
from .worker import Worker

__all__ = ["Server", "ServerConfig", "Worker"]
