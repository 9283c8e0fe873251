"""Remote artifact mirroring via fsspec (the reference's S3 analog).

Port of ``mlp_ppo_2ply_multi_tpu/io/remote.py``. The reference streams
TensorBoard event files to S3 through an error-swallowing RecordWriter
(logger.py:9-56) and uploads checkpoints with boto3
(parameter_manager.py:153-204). Here any fsspec URI works (gs://, s3://
where s3fs is installed, memory:// in tests, plain paths). At run time a
failed upload is printed and swallowed, never fatal: the reference's
degrade-to-local contract. ``fsspec`` is imported when a mirror runs;
``available()`` says whether it imports, so a CLI can refuse up front.
"""
from __future__ import annotations

import os
import time
from typing import Optional


def available() -> bool:
    """Whether ``fsspec`` imports here."""
    try:
        import fsspec  # noqa: F401
    except ImportError:
        return False
    return True


def _fs_for(uri: str):
    import fsspec

    return fsspec.core.url_to_fs(uri)


def sync_dir(local_dir: str, remote_uri: str, verbose: bool = False) -> bool:
    """One-way mirror of ``local_dir`` to ``remote_uri`` (upload new files
    and files whose size changed). Returns True on full success; failures
    are printed and swallowed."""
    try:
        fs, root = _fs_for(remote_uri)
        for dirpath, _, files in os.walk(local_dir):
            rel = os.path.relpath(dirpath, local_dir)
            for f in files:
                src = os.path.join(dirpath, f)
                dst = "/".join(p for p in (root, "" if rel == "." else rel, f) if p)
                try:
                    if fs.exists(dst) and fs.size(dst) == os.path.getsize(src):
                        continue
                except Exception:
                    pass  # an unreadable remote entry is uploaded again
                fs.put_file(src, dst)
                if verbose:
                    print(f"synced {src} -> {remote_uri.rstrip('/')}/{f}")
        return True
    except Exception as e:  # parity: the reference swallows S3 errors (logger.py:25-29)
        print(f"remote sync to {remote_uri} failed (continuing local-only): {e}")
        return False


class RemoteMirror:
    """Rate-limited mirror, no background thread: call ``maybe_sync()`` at
    any cadence; it uploads at most every ``interval_s`` seconds, and
    ``close()`` uploads once more."""

    def __init__(self, local_dir: str, remote_uri: Optional[str], interval_s: float = 60.0):
        self.local_dir = local_dir
        self.remote_uri = remote_uri
        self.interval_s = interval_s
        self._last = 0.0

    def maybe_sync(self) -> None:
        if not self.remote_uri:
            return
        now = time.time()
        if now - self._last >= self.interval_s:
            self._last = now
            sync_dir(self.local_dir, self.remote_uri)

    def close(self) -> None:
        if self.remote_uri:
            sync_dir(self.local_dir, self.remote_uri)
