"""Compressed IO off the critical path.

The reference leans on Hadoop/Spark codecs running in executor threads; here
the host pipeline is one Python process, so naive `gzip.open` puts
(de)compression serially on the thread that feeds (or drains) the device. Two
fixes, both std-lib only:

- ParallelGzipWriter: output compression in a thread pool. Each ~1 MiB text
  block becomes an independent gzip *member* compressed by `zlib` (which
  releases the GIL), and a writer thread appends the members in submission
  order — a concatenation of gzip members is a valid gzip stream
  (RFC 1952 §2.2), which is exactly how pigz parallelises.
- open_gz_subprocess: input decompression in a `gzip -dc` child process, so
  inflate burns a different core than the parse/pack thread. Falls back to
  in-process `gzip.open` when spawning fails.
"""

from __future__ import annotations

import io
import os
import queue
import subprocess
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def _pool() -> ThreadPoolExecutor:
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            n = min(4, os.cpu_count() or 1)
            _POOL = ThreadPoolExecutor(n, thread_name_prefix="stpu-gzip")
        return _POOL


def _gzip_member(data: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, 16 + zlib.MAX_WBITS)
    return co.compress(data) + co.flush()


class ParallelGzipWriter:
    """Text-mode gzip writer that compresses in background threads.

    `write(str)` buffers; once `block_bytes` accumulate, the block is handed
    to the shared pool and the compressed member is appended by a dedicated
    writer thread, preserving order. The caller's thread does no compression
    and (apart from rare backpressure) no disk IO.
    """

    def __init__(self, path: str, level: int = 1, block_bytes: int = 1 << 20,
                 max_inflight: int = 8):
        self._f = open(path, "wb")
        self._level = level
        self._block = block_bytes
        self._buf: list = []
        self._buffered = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=max_inflight)
        self._err: list = []
        self._writer = threading.Thread(target=self._drain, daemon=True)
        self._writer.start()
        self.closed = False

    def _drain(self):
        while True:
            fut = self._q.get()
            if fut is None:
                return
            try:
                self._f.write(fut.result())
            except Exception as e:  # noqa: BLE001
                self._err.append(e)

    def write(self, text: str):
        self._buf.append(text)
        self._buffered += len(text)
        if self._buffered >= self._block:
            self._flush_block()

    def write_bytes(self, data):
        """Buffer pre-encoded ASCII/UTF-8 bytes (native line formatters emit
        bytes; this skips a decode+encode round-trip through str)."""
        self._buf.append(data)
        self._buffered += len(data)
        if self._buffered >= self._block:
            self._flush_block()

    def _flush_block(self):
        if self._err:
            raise self._err[0]
        if not self._buf:
            return
        data = b"".join(
            x.encode() if isinstance(x, str) else x for x in self._buf
        )
        self._buf = []
        self._buffered = 0
        self._q.put(_pool().submit(_gzip_member, data, self._level))

    def close(self):
        if self.closed:
            return
        self._flush_block()
        self._q.put(None)
        self._writer.join()
        self._f.close()
        self.closed = True
        if self._err:
            raise self._err[0]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_gz_subprocess(path: str):
    """Binary read stream of a .gz file, inflated by a `gzip -dc` child
    process (its CPU time leaves this process entirely). The returned file
    object owns the child: closing it reaps the process."""
    try:
        proc = subprocess.Popen(
            ["gzip", "-dc", path],
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            bufsize=1 << 20,
        )
    except OSError:
        import gzip

        return gzip.open(path, "rb")
    assert proc.stdout is not None
    return _ProcStream(proc)


class _ProcStream(io.RawIOBase):
    def __init__(self, proc):
        self._proc = proc
        self._out = proc.stdout

    def readable(self):
        return True

    def read(self, n=-1):
        return self._out.read(n)

    def readinto(self, b):
        return self._out.readinto(b)

    def close(self):
        if not self.closed:
            self._out.close()
            self._proc.wait()
        super().close()
