"""L6/L7 API surface: HTTP agent, JSON codec, Python SDK.

``HTTPAgent`` (the server side, which imports the server and PyTorch)
loads on first use, so a CLI command that only speaks HTTP through the
SDK starts without them.
"""

from .client import APIException, NomadClient
from .codec import decode_job, decode_node, encode

__all__ = ["HTTPAgent", "NomadClient", "APIException", "encode", "decode_job", "decode_node"]


def __getattr__(name):
    if name == "HTTPAgent":
        from .http import HTTPAgent

        return HTTPAgent
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
