"""logmon — task log retention by copy-truncate rotation.

Reference: client/logmon/ (the per-task log-shipper subprocess rotating
FIFO-fed logs under structs.LogConfig: MaxFiles × MaxFileSizeMB, default
10 × 10 MiB). This build's drivers redirect task stdio straight into
files (no FIFO hop), so rotation is copy-truncate: when a stream file
exceeds its cap, the suffixed history shifts (.0 newest … .N oldest,
oldest dropped), the current content is copied to ``.0``, and the live
file is truncated in place — the writer's file descriptor stays valid, no
writer cooperation needed. The fs/logs HTTP endpoints keep serving the
live file; history rides beside it in the task dir.

Trade-off vs the reference's FIFO logmon: copy-truncate is not lossless.
Bytes the task writes between the snapshot copy and the truncate are
dropped. The window is shrunk by copying exactly the snapshot size
(os.pread up to that offset) and, when the file grew during the copy,
re-copying the tail before truncating to zero — but a write that lands
between the final size check and ftruncate is still lost. The reference
avoids this by owning the write path (a FIFO the logmon drains); that
needs writer cooperation this build's direct-to-file drivers don't have.
"""

from __future__ import annotations

import logging
import os
import shutil

log = logging.getLogger("nomad_tpu_torch.logmon")


def rotate_if_needed(path: str, max_files: int, max_file_size_mb: int) -> bool:
    """Rotate one stream file when it exceeds its cap. Returns True when
    a rotation happened."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return False
    if size <= max_file_size_mb * 1024 * 1024:
        return False
    # MaxFiles counts TOTAL files including the live one (structs.LogConfig),
    # so history slots = max_files − 1; max_files=1 ⇒ pure truncation
    history = max(max_files - 1, 0)
    try:
        if history > 0:
            # shift .(h-2) → .(h-1) …; os.replace overwrites, so the
            # oldest slot is dropped by the first shift
            for i in range(history - 2, -1, -1):
                src = f"{path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{path}.{i + 1}")
            # copy-truncate with a minimized loss window: copy under one
            # read fd, then re-copy any tail the writer appended during
            # the copy, and only then truncate. A write landing between
            # the final fstat and ftruncate is still lost (documented
            # module-level trade-off vs the reference's FIFO logmon).
            fd = os.open(path, os.O_RDONLY)
            try:
                with open(f"{path}.0", "wb") as dst:
                    copied = 0
                    while True:
                        chunk = os.pread(fd, 1 << 20, copied)
                        if not chunk:
                            break
                        dst.write(chunk)
                        copied += len(chunk)
                    # tail grown during the copy loop's last read?
                    end = os.fstat(fd).st_size
                    while copied < end:
                        chunk = os.pread(fd, 1 << 20, copied)
                        if not chunk:
                            break
                        dst.write(chunk)
                        copied += len(chunk)
                        end = os.fstat(fd).st_size
            finally:
                os.close(fd)
        with open(path, "r+b") as f:
            f.truncate(0)
        return True
    except OSError:
        log.exception("log rotation failed for %s", path)
        return False


def sweep_alloc(runner) -> int:
    """Rotate every task stream of one alloc runner per its task's
    LogConfig. Returns rotations performed."""
    alloc = runner.alloc
    job = alloc.job
    tg = job.lookup_task_group(alloc.task_group) if job else None
    if tg is None:
        return 0
    n = 0
    for task in tg.tasks:
        lc = getattr(task, "log_config", None)
        if lc is None:
            continue
        task_dir = os.path.join(runner.alloc_dir, task.name)
        for stream in ("stdout", "stderr"):
            if rotate_if_needed(
                os.path.join(task_dir, f"{task.name}.{stream}"),
                lc.max_files,
                lc.max_file_size_mb,
            ):
                n += 1
    return n
