"""ctypes binding for the C++ WAL store (the repo's
``native/walstore.cpp``, built with ``g++`` into
``build/nomad_tpu_torch/``), with a pure-Python store implementing the
identical interface. This is host durability code, not a device kernel.

Role in the framework (mirrors the reference's native-speed durable
stores): Raft log + stable store (raft-boltdb analog) and client local
state (BoltDB / helper/boltdd analog, client/state/). Entries are
(index, term, type, payload) records with CRC framing; torn tails are
truncated on open; suffix truncation serves Raft conflict resolution and
prefix compaction follows snapshots.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading
import zlib
from typing import Optional, Tuple

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SO_PATH = os.path.join(_REPO_ROOT, "build", "nomad_tpu_torch", "libnomadwal.so")
_SRC_PATH = os.path.join(_REPO_ROOT, "native", "walstore.cpp")

_lib = None
_lib_lock = threading.Lock()


def _build_so() -> bool:
    try:
        os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
        # built beside its final name and renamed into place, so a
        # process loading it never sees a half-written library
        tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O2", "-fPIC", "-std=c++17", "-shared", "-o", tmp, _SRC_PATH],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _SO_PATH)
        return True
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if os.path.exists(_SRC_PATH):
            stale = (
                not os.path.exists(_SO_PATH)
                or os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC_PATH)
            )
            if stale and not _build_so():
                return None
        elif not os.path.exists(_SO_PATH):
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None
        lib.wal_open.restype = ctypes.c_void_p
        lib.wal_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.wal_close.argtypes = [ctypes.c_void_p]
        lib.wal_first_index.restype = ctypes.c_uint64
        lib.wal_first_index.argtypes = [ctypes.c_void_p]
        lib.wal_last_index.restype = ctypes.c_uint64
        lib.wal_last_index.argtypes = [ctypes.c_void_p]
        lib.wal_append.restype = ctypes.c_int
        lib.wal_append.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.wal_get.restype = ctypes.c_int
        lib.wal_get.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_char_p, ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.wal_truncate_suffix.restype = ctypes.c_int
        lib.wal_truncate_suffix.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.wal_compact_prefix.restype = ctypes.c_int
        lib.wal_compact_prefix.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.wal_sync.restype = ctypes.c_int
        lib.wal_sync.argtypes = [ctypes.c_void_p]
        lib.wal_kv_set.restype = ctypes.c_int
        lib.wal_kv_set.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.wal_kv_get.restype = ctypes.c_int
        lib.wal_kv_get.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.wal_last_error.restype = ctypes.c_char_p
        lib.wal_last_error.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class WalError(Exception):
    pass


class _NativeWal:
    def __init__(self, lib, path: str, max_segment_bytes: int):
        self._lib = lib
        self._h = lib.wal_open(path.encode(), max_segment_bytes)
        if not self._h:
            raise WalError(f"wal_open failed for {path}")

    def close(self):
        if self._h:
            self._lib.wal_close(self._h)
            self._h = None

    def _handle(self):
        h = self._h
        if not h:
            raise WalError("wal store is closed")
        return h

    def first_index(self) -> int:
        return self._lib.wal_first_index(self._handle())

    def last_index(self) -> int:
        return self._lib.wal_last_index(self._handle())

    def append(self, index: int, term: int, type_: int, data: bytes) -> None:
        rc = self._lib.wal_append(self._handle(), index, term, type_, data, len(data))
        if rc != 0:
            raise WalError(self._lib.wal_last_error(self._h).decode())

    def get(self, index: int) -> Tuple[int, int, bytes]:
        term = ctypes.c_uint64()
        type_ = ctypes.c_uint32()
        outlen = ctypes.c_uint32()
        rc = self._lib.wal_get(self._handle(), index, term, type_, None, 0, outlen)
        if rc == -3:
            raise KeyError(index)
        if rc != 0:
            raise WalError(self._lib.wal_last_error(self._h).decode())
        buf = ctypes.create_string_buffer(outlen.value)
        rc = self._lib.wal_get(self._handle(), index, term, type_, buf, outlen.value, outlen)
        if rc != 0:
            raise WalError(self._lib.wal_last_error(self._h).decode())
        return term.value, type_.value, buf.raw[: outlen.value]

    def truncate_suffix(self, from_index: int) -> None:
        if self._lib.wal_truncate_suffix(self._handle(), from_index) != 0:
            raise WalError(self._lib.wal_last_error(self._h).decode())

    def compact_prefix(self, to_index: int) -> None:
        if self._lib.wal_compact_prefix(self._handle(), to_index) != 0:
            raise WalError(self._lib.wal_last_error(self._h).decode())

    def sync(self) -> None:
        self._lib.wal_sync(self._handle())

    def kv_set(self, key: str, value: bytes) -> None:
        if self._lib.wal_kv_set(self._handle(), key.encode(), value, len(value)) != 0:
            raise WalError("kv_set failed")

    def kv_get(self, key: str) -> Optional[bytes]:
        n = self._lib.wal_kv_get(self._handle(), key.encode(), None, 0)
        if n < 0:
            return None
        buf = ctypes.create_string_buffer(n or 1)
        self._lib.wal_kv_get(self._handle(), key.encode(), buf, n)
        return buf.raw[:n]


_REC = struct.Struct("<IIQQI")  # crc, len, index, term, type — matches C++


class _PyWal:
    """Pure-Python fallback; same on-disk format as the C++ store, so the
    two are interchangeable on the same directory."""

    def __init__(self, path: str, max_segment_bytes: int):
        self.dir = path
        self.max_segment_bytes = max_segment_bytes or (16 << 20)
        os.makedirs(path, exist_ok=True)
        self._entries: dict[int, tuple[int, int, bytes]] = {}
        self._first = 0
        self._last = 0
        self._kv: dict[str, bytes] = {}
        self._segments: list[tuple[int, str]] = []  # (first_index, path)
        self._tail: Optional[object] = None
        self._tail_size = 0
        self._scan()
        self._load_kv()

    def _scan(self):
        segs = sorted(
            f for f in os.listdir(self.dir) if f.endswith(".seg") and len(f) == 24
        )
        for si, name in enumerate(segs):
            p = os.path.join(self.dir, name)
            good_off = 0
            with open(p, "rb") as f:
                data = f.read()
            off = 0
            while off + _REC.size <= len(data):
                crc, ln, index, term, typ = _REC.unpack_from(data, off)
                end = off + _REC.size + ln
                if ln > (64 << 20) or end > len(data):
                    break
                body = data[off + 4 : end]
                if zlib.crc32(body) & 0xFFFFFFFF != crc:
                    break
                expect = index if self._first == 0 else self._last + 1
                if self._first != 0 and index != expect:
                    break
                if self._first == 0:
                    self._first = index
                self._last = index
                self._entries[index] = (term, typ, data[off + _REC.size : end])
                off = end
                good_off = off
            if good_off < len(data):
                with open(p, "r+b") as f:
                    f.truncate(good_off)
            self._segments.append((int(name[:20]), p))
            # A later segment is orphaned only when it is NON-CONTIGUOUS
            # with what survived (lost entries); a torn tail whose entries
            # all parsed keeps its successors — exactly the C++ open()
            # rule, keeping the two backends interchangeable on one dir.
            next_first = (
                int(segs[si + 1][:20]) if si + 1 < len(segs) else None
            )
            if next_first is not None and (
                self._last == 0 or next_first != self._last + 1
            ):
                for later in segs[si + 1 :]:
                    os.unlink(os.path.join(self.dir, later))
                break
        if self._segments:
            first, p = self._segments[-1]
            self._tail = open(p, "ab")
            self._tail_size = os.path.getsize(p)

    def _load_kv(self):
        p = os.path.join(self.dir, "meta.kv")
        if not os.path.exists(p):
            return
        with open(p, "rb") as f:
            data = f.read()
        if len(data) < 8:
            return
        crc, count = struct.unpack_from("<II", data, 0)
        if zlib.crc32(data[4:]) & 0xFFFFFFFF != crc:
            return
        off = 8
        for _ in range(count):
            kl, vl = struct.unpack_from("<II", data, off)
            off += 8
            k = data[off : off + kl].decode()
            v = data[off + kl : off + kl + vl]
            off += kl + vl
            self._kv[k] = v

    def _save_kv(self):
        body = struct.pack("<I", len(self._kv))
        for k, v in sorted(self._kv.items()):
            kb = k.encode()
            body += struct.pack("<II", len(kb), len(v)) + kb + v
        blob = struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF) + body
        tmp = os.path.join(self.dir, "meta.kv.tmp")
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.dir, "meta.kv"))

    def close(self):
        if self._tail:
            self._tail.close()
            self._tail = None

    def first_index(self) -> int:
        return self._first

    def last_index(self) -> int:
        return self._last

    def _roll(self, next_index: int):
        if self._tail:
            self._tail.close()
        name = f"{next_index:020d}.seg"
        p = os.path.join(self.dir, name)
        self._tail = open(p, "wb")
        self._tail_size = 0
        self._segments.append((next_index, p))

    def append(self, index: int, term: int, type_: int, data: bytes) -> None:
        if len(data) > (64 << 20):  # scanner rejects larger as corruption
            raise WalError("record exceeds 64MB limit")
        expect = index if self._first == 0 else self._last + 1
        if index != expect:
            raise WalError(f"non-contiguous append at {index}")
        if self._tail is None or self._tail_size >= self.max_segment_bytes:
            self._roll(index)
        body = _REC.pack(0, len(data), index, term, type_)[4:] + data
        crc = zlib.crc32(body) & 0xFFFFFFFF
        self._tail.write(struct.pack("<I", crc) + body)
        # Flush through to the OS so a crash-stop (SIGKILL) loses nothing —
        # the native store writes via unbuffered fds and has the same
        # property; fsync (power-loss durability) remains sync()'s job.
        self._tail.flush()
        self._tail_size += _REC.size + len(data)
        if self._first == 0:
            self._first = index
        self._last = index
        self._entries[index] = (term, type_, data)

    def get(self, index: int) -> Tuple[int, int, bytes]:
        if index not in self._entries:
            raise KeyError(index)
        return self._entries[index]

    def truncate_suffix(self, from_index: int) -> None:
        if self._first == 0 or from_index > self._last:
            return
        # Simple fallback: rewrite surviving entries into one fresh segment.
        survivors = [
            (i, *self._entries[i]) for i in range(self._first, from_index)
        ]
        if self._tail:
            self._tail.close()
            self._tail = None
        for _, p in self._segments:
            os.unlink(p)
        self._segments = []
        self._entries = {}
        self._first = self._last = 0
        for i, term, typ, data in survivors:
            self.append(i, term, typ, data)
        if self._tail:
            self._tail.flush()

    def compact_prefix(self, to_index: int) -> None:
        # Segment-granular like the native store: drop whole segments whose
        # entries all fall at or below to_index.
        drop = 0
        for i in range(len(self._segments) - 1):
            if self._segments[i + 1][0] - 1 <= to_index:
                drop = i + 1
            else:
                break
        if not drop:
            return
        new_first = self._segments[drop][0]
        for _, p in self._segments[:drop]:
            os.unlink(p)
        self._segments = self._segments[drop:]
        for i in range(self._first, new_first):
            self._entries.pop(i, None)
        self._first = new_first

    def sync(self) -> None:
        if self._tail:
            self._tail.flush()
            os.fsync(self._tail.fileno())

    def kv_set(self, key: str, value: bytes) -> None:
        self._kv[key] = value
        self._save_kv()

    def kv_get(self, key: str) -> Optional[bytes]:
        return self._kv.get(key)


def WalStore(path: str, max_segment_bytes: int = 0, force_python: bool = False):
    """Open (creating if needed) a WAL store at ``path``.

    Returns the native C++ store when the toolchain/library is available,
    else the pure-Python fallback. Both speak the same on-disk format.
    """
    if not force_python:
        lib = _load()
        if lib is not None:
            return _NativeWal(lib, path, max_segment_bytes)
    return _PyWal(path, max_segment_bytes)
