"""Filesystem-backed object store (port of
``openmp_parallel_computing_tpu.dispatch.store``, the same layout).

Capability twin of the reference's MinIO usage (bucket ``images`` with
``uploads/{uuid}_{name}`` -> ``processed/{basename}`` layout,
``event-driven/frontend/app.py:289-297`` and
``event-driven/grayscale_service/app.py:46-77``): put/get/exists/list with
atomic writes (tmp + rename) and streaming reads. Persistent across
restarts, shareable between processes on one host — the single-host stand-in
for an S3-class service, behind the same minimal interface.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Iterator


class ObjectStore:
    def __init__(self, root: str | os.PathLike, bucket: str = "images"):
        self.root = Path(root) / bucket
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        p = (self.root / key).resolve()
        if not p.is_relative_to(self.root.resolve()):
            raise ValueError(f"key escapes store root: {key!r}")
        return p

    def put(self, key: str, data: bytes) -> str:
        """Atomic write; returns the key."""
        dst = self._path(key)
        dst.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=dst.parent, prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, dst)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return key

    def put_file(self, key: str, path: str | os.PathLike) -> str:
        return self.put(key, Path(path).read_bytes())

    def get(self, key: str) -> bytes:
        return self._path(key).read_bytes()

    def get_stream(self, key: str, chunk_size: int = 32 * 1024
                   ) -> Iterator[bytes]:
        """Chunked read (the worker streams downloads in 32 KiB chunks,
        grayscale_service/app.py:46-51)."""
        with open(self._path(key), "rb") as f:
            while chunk := f.read(chunk_size):
                yield chunk

    def exists(self, key: str) -> bool:
        return self._path(key).is_file()

    def delete(self, key: str) -> None:
        p = self._path(key)
        if p.is_file():
            p.unlink()

    def list(self, prefix: str = "") -> list[str]:
        base = self.root
        out = []
        for p in base.rglob("*"):
            if p.is_file() and not p.name.startswith(".tmp-"):
                key = str(p.relative_to(base))
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)
