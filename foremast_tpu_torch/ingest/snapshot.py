"""crc-framed append-log records and snapshot-directory helpers.

The port's copy of the framing half of the JAX package's
`foremast_tpu/ingest/snapshot.py`, byte for byte the same format (magic,
header, crc), so a log written by one package reads in the other. Each
record is appended and flushed at write time: the page cache owns the
bytes once `append_record` returns, so they survive a SIGKILL (only
power loss needs fsync, which judgment state does not warrant). A reader
serves every intact record up to the first torn or corrupt frame and
trusts nothing after it.
"""

from __future__ import annotations

import os
import struct
import zlib

_LOG_MAGIC = b"FMRL"
# magic(4) + payload_len(u32) + crc32(u32)
_LOG_HEADER = struct.Struct("<4sII")

# the discard reasons of the fit journals
# (`foremast_snapshot_discards{reason}` in the JAX package)
DISCARD_REASONS = ("fit_unreadable", "fit_torn")


def append_record(fh, payload: bytes) -> int:
    """Frame + append one payload; returns bytes written. The caller
    holds whatever lock serializes the file handle."""
    header = _LOG_HEADER.pack(_LOG_MAGIC, len(payload), zlib.crc32(payload))
    fh.write(header + payload)
    fh.flush()  # page cache now owns the bytes: SIGKILL-safe
    return len(header) + len(payload)


def read_record_stream(fh):
    """Yield (payload, None) per intact record from an open binary
    stream, then (None, "torn_log") once if the tail is torn: a short
    header or payload, bad magic, a crc mismatch. Everything before the
    first bad frame is served; nothing after it is trusted (a corrupt
    length field would desync every later frame)."""
    while True:
        header = fh.read(_LOG_HEADER.size)
        if not header:
            return  # clean EOF
        if len(header) < _LOG_HEADER.size:
            yield None, "torn_log"
            return
        magic, length, crc = _LOG_HEADER.unpack(header)
        if magic != _LOG_MAGIC:
            yield None, "torn_log"
            return
        payload = fh.read(length)
        if len(payload) < length or zlib.crc32(payload) != crc:
            yield None, "torn_log"
            return
        yield payload, None


def read_records(path: str):
    """`read_record_stream` over a file path (missing file = no records)."""
    try:
        fh = open(path, "rb")
    except OSError:
        return
    with fh:
        yield from read_record_stream(fh)


def lock_snapshot_dir(directory: str):
    """Advisory EXCLUSIVE lock on a snapshot directory: two live workers
    appending to the same logs through independent handles would
    interleave torn frames. Returns an open handle (keep it referenced
    for the process lifetime) or None when another LIVE process holds
    the directory. flock releases on process death, SIGKILL included, so
    a crashed worker's replacement acquires it at once."""
    import fcntl

    os.makedirs(directory, exist_ok=True)
    fh = open(os.path.join(directory, ".lock"), "a+")
    try:
        fcntl.flock(fh.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        fh.close()
        return None
    return fh


def atomic_write(path: str, data: bytes) -> None:
    """Write bytes to a temp file in the target directory, then
    os.replace into place: readers see the old file or the new one,
    never a prefix."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
