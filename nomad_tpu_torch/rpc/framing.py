"""Wire framing: u32 big-endian length prefix + serialized message dict.

Messages:
  request   {"seq": int, "method": str, "args": Any}
  response  {"seq": int, "result": Any}           (unary)
  error     {"seq": int, "error": str}
  chunk     {"seq": int, "chunk": Any, "more": bool}   (streaming)

Serialization is pickle restricted on the *receive* side: ``recv_frame``
(and ``restricted_loads``, which snapshot files go through) resolves
globals through an allowlist (the port's struct dataclasses and enums, a
few stdlib containers, numpy array reconstruction) so a crafted frame
from an untrusted peer cannot reach arbitrary callables — the classic
pickle-deserialization RCE. A pickle that names a class of another
package (the JAX package's ``nomad_tpu.*`` included) is refused: each
package reads its own frames and files. The reference's wire format is
msgpack over TLS/mTLS (nomad/rpc.go); here the codec restriction plus
optional HMAC transport auth (below) covers the same trust boundary.

Transport auth: when a cluster secret is configured (``set_rpc_secret`` or
the NOMAD_TPU_RPC_SECRET env var), every frame carries an HMAC-SHA256 tag
over direction byte + payload, and unauthenticated frames are rejected
before deserialization. Scope of the guarantee: the MAC authenticates
*cluster membership* (only secret holders can produce acceptable frames)
and direction (a server frame cannot be reflected back as a request); it
does NOT provide per-frame freshness — a captured frame can be replayed
verbatim by an on-path attacker until the secret rotates. Deployments
needing replay protection should run the RPC ports over a trusted network
or a TLS tunnel, as the reference does (nomad/rpc.go TLS wrap).

The 64 MB frame cap matches the WAL's record cap; anything larger is a
protocol violation, not data.

The JAX package's ``rpc/framing.py`` with the allowed modules rewritten
to the port's. Its users here: snapshot restore, ``rpc/server.py`` and
``rpc/client.py`` (the client endpoints, the HTTP proxy of
``alloc logs`` / ``alloc fs``, and a cluster's raft, gossip and
forwarded writes), and ``raft/node.py``'s replicated log entries and
durable removed-peer set.
"""

from __future__ import annotations

import hashlib
import hmac
import importlib
import io
import os
import pickle
import socket
import struct
from typing import Any, Optional

MAX_FRAME = 64 << 20
_LEN = struct.Struct(">I")
_TAG_LEN = hashlib.sha256().digest_size

_FLAG_PLAIN = 0
_FLAG_HMAC = 1  # bit 0: authenticated
_FLAG_DIR_S = 2  # bit 1: direction server→client (0 = client→server)

_secret: Optional[bytes] = None
_secret_loaded = False


def set_rpc_secret(secret: Optional[bytes | str]) -> None:
    """Configure the cluster transport secret (all peers must agree)."""
    global _secret, _secret_loaded
    if isinstance(secret, str):
        secret = secret.encode()
    _secret = secret or None
    _secret_loaded = True


def _get_secret() -> Optional[bytes]:
    global _secret, _secret_loaded
    if not _secret_loaded:
        env = os.environ.get("NOMAD_TPU_RPC_SECRET")
        _secret = env.encode() if env else None
        _secret_loaded = True
    return _secret


class FramingError(Exception):
    pass


# -- restricted deserialization ----------------------------------------------

# Modules whose classes may cross the wire. A fixed set — find_class must
# not import attacker-named modules (side-effectful imports can hang or latch
# process state).
_SAFE_MODULES = frozenset(
    {
        "nomad_tpu_torch.structs",
        "nomad_tpu_torch.structs.job",
        "nomad_tpu_torch.structs.node",
        "nomad_tpu_torch.structs.alloc",
        "nomad_tpu_torch.structs.evaluation",
        "nomad_tpu_torch.structs.plan",
        "nomad_tpu_torch.structs.resources",
        "nomad_tpu_torch.structs.network",
        "nomad_tpu_torch.structs.volumes",
        "nomad_tpu_torch.structs.deployment",
        "nomad_tpu_torch.state.store",
        "nomad_tpu_torch.acl.tokens",
        "nomad_tpu_torch.acl.policy",
    }
)

_SAFE_GLOBALS = {
    ("builtins", "set"),
    ("builtins", "frozenset"),
    ("builtins", "bytearray"),
    ("builtins", "complex"),
    ("builtins", "slice"),
    ("builtins", "range"),
    ("collections", "OrderedDict"),
    ("collections", "deque"),
    ("datetime", "datetime"),
    ("datetime", "date"),
    ("datetime", "time"),
    ("datetime", "timedelta"),
    ("datetime", "timezone"),
    # numpy array reconstruction (structs.resources carries ndarrays)
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy._core.numeric", "_frombuffer"),
}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _SAFE_GLOBALS:
            return super().find_class(module, name)
        # Framework types: classes from the fixed struct-module set only.
        # NOTE the actual invariant: functions never resolve, but the
        # allowlisted CLASSES remain callable with attacker-chosen args —
        # pickle's REDUCE opcode invokes cls(*args), running __init__.
        # Safety therefore rests on every allowlisted class being a
        # side-effect-free data class (keep it that way when extending
        # _SAFE_MODULES; a class whose __init__ touches files/sockets/
        # subprocesses would reopen a gadget).
        if module in _SAFE_MODULES:
            try:
                mod = importlib.import_module(module)
            except Exception as e:  # noqa: BLE001 — error contract
                raise FramingError(f"cannot resolve RPC global module: {module}") from e
            obj = getattr(mod, name, None)
            if isinstance(obj, type) and obj.__module__ == module:
                return obj
        raise FramingError(f"disallowed global in RPC frame: {module}.{name}")


def restricted_loads(payload: bytes) -> Any:
    """Deserialize with the framework allowlist — for any bytes whose
    producer is not fully trusted (RPC frames, replicated log entries)."""
    try:
        return _RestrictedUnpickler(io.BytesIO(payload)).load()
    except FramingError:
        raise
    except Exception as e:  # torn/corrupt pickle must not crash callers
        raise FramingError(f"malformed frame payload: {e}") from e


# -- framing -----------------------------------------------------------------


def send_frame(sock: socket.socket, msg: dict, *, server_side: bool = False) -> None:
    """``server_side`` marks the frame's direction (server→client); the
    direction byte is covered by the MAC so a captured server frame cannot
    be reflected back at the server as a request."""
    payload = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    if len(payload) > MAX_FRAME:
        raise FramingError(f"frame too large: {len(payload)}")
    flag = _FLAG_DIR_S if server_side else 0
    secret = _get_secret()
    if secret is not None:
        flag |= _FLAG_HMAC
        tag = hmac.new(secret, bytes([flag]) + payload, hashlib.sha256).digest()
        header = _LEN.pack(len(payload) + 1 + _TAG_LEN) + bytes([flag])
        sock.sendall(header + tag + payload)
    else:
        sock.sendall(_LEN.pack(len(payload) + 1) + bytes([flag]) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("connection closed")
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock: socket.socket, *, expect_server: bool | None = None) -> Any:
    """``expect_server`` asserts the authenticated frame's direction:
    True = must come from a server, False = must come from a client,
    None = either (direction unchecked)."""
    (n,) = _LEN.unpack(_recv_exact(sock, 4))
    if n > MAX_FRAME + 1 + _TAG_LEN or n < 1:
        raise FramingError(f"bad frame length: {n}")
    body = _recv_exact(sock, n)
    flag, body = body[0], body[1:]
    if flag & ~(_FLAG_HMAC | _FLAG_DIR_S):
        raise FramingError(f"unknown frame flag: {flag}")
    secret = _get_secret()
    if secret is not None:
        if not flag & _FLAG_HMAC or len(body) < _TAG_LEN:
            raise FramingError("unauthenticated frame rejected")
        tag, payload = body[:_TAG_LEN], body[_TAG_LEN:]
        if not hmac.compare_digest(
            tag, hmac.new(secret, bytes([flag]) + payload, hashlib.sha256).digest()
        ):
            raise FramingError("frame HMAC mismatch")
        if expect_server is not None and bool(flag & _FLAG_DIR_S) != expect_server:
            raise FramingError("frame direction mismatch (reflected frame?)")
    else:
        if flag & _FLAG_HMAC:
            if len(body) < _TAG_LEN:
                raise FramingError("truncated authenticated frame")
            payload = body[_TAG_LEN:]  # peer signs, we don't require it
        else:
            payload = body
    return restricted_loads(payload)
