"""Restricted deserialization for bytes from a producer that is not
fully trusted: snapshot files, and later RPC frames and replicated log
entries.

The unpickler resolves globals through an allowlist (the port's struct
dataclasses and enums, a few stdlib containers, numpy array
reconstruction), so a crafted payload cannot reach arbitrary callables —
the classic pickle-deserialization RCE. A pickle that names a class of
another package (the JAX package's ``nomad_tpu.*`` included) is refused:
each package restores its own files.

This is the deserialization half of the JAX package's ``rpc/framing.py``
(``FramingError``, ``_SAFE_GLOBALS``, ``_RestrictedUnpickler``,
``restricted_loads``), with the allowed modules rewritten to the port's.
The wire framing, transport auth and the rest of ``rpc/`` are not ported
yet (ROADMAP A18); neither is ``acl/``, so a snapshot that holds ACL
policies or tokens is refused too.
"""

from __future__ import annotations

import importlib
import io
import pickle
from typing import Any


class FramingError(Exception):
    pass


# -- restricted deserialization ----------------------------------------------

# Modules whose classes may cross the wire. A fixed set — find_class must
# not import attacker-named modules (side-effectful imports can hang or
# latch process state).
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
