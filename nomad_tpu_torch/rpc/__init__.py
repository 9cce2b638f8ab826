"""Internal RPC — the framework's server↔server / client↔server transport.

Reference: nomad/rpc.go (msgpack-RPC multiplexed over yamux :24-30,
handleConn :195), helper/pool (server-to-server connection pool), and the
streaming-RPC registry (nomad/server.go:158). Here: length-prefixed frames
over TCP with sequence-id multiplexing (many in-flight calls per
connection — the yamux role), thread-per-request dispatch, and streaming
responses for logs/exec/event feeds.

Payloads are pickled Python structs, restricted on receipt to the port's
own struct classes (``framing.py``). The dev agent's client endpoints,
the HTTP proxy of ``alloc logs`` / ``alloc fs``, and a server cluster's
raft, gossip and forwarded writes (``raft/node.py``,
``server/gossip.py``, ``server/cluster.py``) ride it.
"""

from .client import RPCClient, RPCError
from .server import RPCServer

__all__ = ["RPCClient", "RPCServer", "RPCError"]
