"""Native runtime components (C++, bound via ctypes).

The Raft log rides the repo's C++ segmented WAL + durable KV
(``native/walstore.cpp``), compiled with ``g++`` on first use into
``build/nomad_tpu_torch/`` and bound with ctypes. A pure-Python store with
the same interface keeps the package working where no toolchain is
present.
"""

from .wal import WalStore, native_available  # noqa: F401
