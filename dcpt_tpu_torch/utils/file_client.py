"""Byte-store backends (dcpt_tpu/utils/file_client.py): the disk backend.

LMDB and memcached come with the slices that use them.
"""

from __future__ import annotations


class HardDiskBackend:
    """Raw filesystem reads."""

    def get(self, filepath) -> bytes:
        with open(str(filepath), "rb") as f:
            return f.read()


class FileClient:
    """Dispatch to a storage backend by name."""

    _backends = {"disk": HardDiskBackend}

    def __init__(self, backend: str = "disk", **kwargs):
        if backend not in self._backends:
            raise ValueError(f"Backend {backend} is not supported. Currently supported ones are "
                             f"{list(self._backends.keys())}")
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath, client_key: str = "default") -> bytes:
        return self.client.get(filepath)
