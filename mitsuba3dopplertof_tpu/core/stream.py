"""Generic binary stream layer (host-side I/O).

Rebuild of the reference's stream abstraction
(reference include/mitsuba/core/stream.h, src/core/{stream,fstream,
mstream,zstream,dstream,mmap}.cpp): a byte-oriented ``Stream`` base with
endianness-aware typed serialization, concrete file/memory/compressed/
counting implementations, and a memory-mapped file wrapper. The renderer's
structured readers (mesh loaders, tensor files, bitmap codecs) sit on top;
the layer is also the public serialization surface for user tooling.

Semantics matched to the reference:
  * typed read/write swap bytes iff the stream byte order differs from the
    host's (stream.h:238-247); the raw ``read_bytes``/``write_bytes`` do NOT
    swap (stream.h:83-92)
  * reading past the end raises (``fstream.cpp`` "premature end of file")
  * ``MemoryStream`` grows à la std::vector unless constructed over a
    pre-allocated buffer, which never resizes (mstream.h:28-35)
  * ``ZStream`` wraps a child stream with DEFLATE or GZIP framing
    (zstream.h EZStreamType)
  * ``DummyStream`` implements the full interface, swallows writes, and
    only tracks size/position (dstream.cpp)
  * strings serialize as u32 length + UTF-8 bytes
"""

from __future__ import annotations

import io
import mmap as _mmap
import os
import struct
import sys
import zlib

__all__ = ["Stream", "FileStream", "MemoryStream", "ZStream", "DummyStream",
           "MemoryMappedFile", "EByteOrder"]


class EByteOrder:
    """Stream byte orders (reference stream.h:43-47)."""
    BigEndian = 0
    LittleEndian = 1
    NetworkByteOrder = BigEndian


_HOST_ORDER = (EByteOrder.LittleEndian if sys.byteorder == "little"
               else EByteOrder.BigEndian)

# struct format char per typed accessor
_FMT = {"i8": "b", "u8": "B", "i16": "h", "u16": "H", "i32": "i",
        "u32": "I", "i64": "q", "u64": "Q", "f16": "e", "f32": "f",
        "f64": "d", "bool": "?"}


class Stream:
    """Abstract seekable byte stream with endianness-aware serialization."""

    def __init__(self):
        self._byte_order = _HOST_ORDER
        self._closed = False

    # -- abstract byte interface ------------------------------------------
    def read_bytes(self, size: int) -> bytes:
        raise NotImplementedError

    def write_bytes(self, data: bytes) -> None:
        raise NotImplementedError

    def seek(self, pos: int) -> None:
        raise NotImplementedError

    def tell(self) -> int:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def truncate(self, size: int) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def can_read(self) -> bool:
        raise NotImplementedError

    def can_write(self) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        self._closed = True

    def is_closed(self) -> bool:
        return self._closed

    # -- endianness (reference stream.h:224-257) --------------------------
    def set_byte_order(self, order: int) -> None:
        self._byte_order = order

    def byte_order(self) -> int:
        return self._byte_order

    @staticmethod
    def host_byte_order() -> int:
        return _HOST_ORDER

    def needs_endianness_swap(self) -> bool:
        return self._byte_order != _HOST_ORDER

    # -- typed serialization ----------------------------------------------
    def _endian_char(self) -> str:
        return "<" if self._byte_order == EByteOrder.LittleEndian else ">"

    def _read_fmt(self, code: str):
        fmt = self._endian_char() + _FMT[code]
        n = struct.calcsize(fmt)
        data = self.read_bytes(n)
        return struct.unpack(fmt, data)[0]

    def _write_fmt(self, code: str, value) -> None:
        fmt = self._endian_char() + _FMT[code]
        self.write_bytes(struct.pack(fmt, value))

    def read_string(self) -> str:
        n = self._read_fmt("u32")
        return self.read_bytes(n).decode("utf-8")

    def write_string(self, s: str) -> None:
        data = s.encode("utf-8")
        self._write_fmt("u32", len(data))
        self.write_bytes(data)

    def read_array(self, dtype, count: int):
        """Read ``count`` elements of numpy ``dtype`` (endianness applied)."""
        import numpy as np
        dt = np.dtype(dtype).newbyteorder(self._endian_char())
        data = self.read_bytes(dt.itemsize * count)
        return np.frombuffer(data, dtype=dt, count=count).astype(
            np.dtype(dtype), copy=False)

    def write_array(self, arr) -> None:
        import numpy as np
        a = np.asarray(arr)
        self.write_bytes(
            a.astype(a.dtype.newbyteorder(self._endian_char())).tobytes())

    # -- text conveniences (reference stream.cpp read_line/read_token) ----
    def read_line(self) -> str:
        out = bytearray()
        while self.tell() < self.size():
            c = self.read_bytes(1)
            if c == b"\n":
                break
            out += c
        return out.decode("utf-8").rstrip("\r")

    def read_token(self) -> str:
        out = bytearray()
        while self.tell() < self.size():
            c = self.read_bytes(1)
            if c in b" \t\r\n":
                if out:
                    break
                continue
            out += c
        return out.decode("utf-8")

    def write_line(self, text: str) -> None:
        self.write_bytes(text.encode("utf-8") + b"\n")

    def skip(self, amount: int) -> None:
        self.seek(self.tell() + amount)

    def __repr__(self):
        return (f"{type(self).__name__}[byte_order="
                f"{'LE' if self._byte_order else 'BE'}, "
                f"pos={'?' if self.is_closed() else self.tell()}]")


# typed accessors: stream.read_u32() / stream.write_f32(x) for every code
def _make_reader(code):
    def read(self):
        return self._read_fmt(code)
    read.__name__ = f"read_{code}"
    return read


def _make_writer(code):
    def write(self, value):
        self._write_fmt(code, value)
    write.__name__ = f"write_{code}"
    return write


for _code in _FMT:
    setattr(Stream, f"read_{_code}", _make_reader(_code))
    setattr(Stream, f"write_{_code}", _make_writer(_code))


def _check_open(s: "Stream"):
    if s.is_closed():
        raise RuntimeError(f"{type(s).__name__}: stream is closed")


class FileStream(Stream):
    """File-backed stream (reference fstream.cpp). Modes mirror
    FileStream::EMode: 'r' (ERead), 'r+' (EReadWrite),
    'w+' (ETruncReadWrite)."""

    ERead = "r"
    EReadWrite = "r+"
    ETruncReadWrite = "w+"

    def __init__(self, path, mode: str = "r"):
        super().__init__()
        if mode not in ("r", "r+", "w+"):
            raise RuntimeError(f"FileStream: invalid mode '{mode}'")
        self.path = str(path)
        self._mode = mode
        self._f = open(self.path, mode + "b")

    def can_read(self) -> bool:
        return True

    def can_write(self) -> bool:
        return self._mode != "r"

    def read_bytes(self, size: int) -> bytes:
        _check_open(self)
        data = self._f.read(size)
        if len(data) != size:
            raise EOFError(
                f"FileStream '{self.path}': read {len(data)}/{size} bytes "
                "(premature end of file)")
        return data

    def write_bytes(self, data: bytes) -> None:
        _check_open(self)
        if not self.can_write():
            raise RuntimeError(f"FileStream '{self.path}' is read-only")
        self._f.write(data)

    def seek(self, pos: int) -> None:
        _check_open(self)
        self._f.seek(pos)

    def tell(self) -> int:
        _check_open(self)
        return self._f.tell()

    def size(self) -> int:
        _check_open(self)
        pos = self._f.tell()
        self._f.seek(0, io.SEEK_END)
        end = self._f.tell()
        self._f.seek(pos)
        return end

    def truncate(self, size: int) -> None:
        _check_open(self)
        if not self.can_write():
            raise RuntimeError(f"FileStream '{self.path}' is read-only")
        self._f.truncate(size)
        if self._f.tell() > size:
            self._f.seek(size)

    def flush(self) -> None:
        _check_open(self)
        self._f.flush()

    def close(self) -> None:
        if not self._closed:
            self._f.close()
        super().close()


class MemoryStream(Stream):
    """Growable in-memory stream; a pre-allocated buffer never resizes
    (reference mstream.h:19-35, mstream.cpp)."""

    def __init__(self, capacity_or_buffer=512):
        super().__init__()
        if isinstance(capacity_or_buffer, int):
            self._buf = bytearray(capacity_or_buffer)
            self._owned = True
            self._size = 0
            self._capacity = capacity_or_buffer
        else:
            self._buf = capacity_or_buffer     # external bytearray/memoryview
            self._owned = False
            self._size = len(self._buf)
            self._capacity = len(self._buf)
        self._pos = 0

    def can_read(self) -> bool:
        return True

    def can_write(self) -> bool:
        return True

    def owns_buffer(self) -> bool:
        return self._owned

    def capacity(self) -> int:
        return self._capacity

    def raw_buffer(self) -> bytes:
        return bytes(self._buf[:self._size])

    def read_bytes(self, size: int) -> bytes:
        _check_open(self)
        if self._pos + size > self._size:
            got = max(self._size - self._pos, 0)
            self._pos = self._size
            raise EOFError(f"MemoryStream: read {got}/{size} bytes "
                           "(premature end of stream)")
        data = bytes(self._buf[self._pos:self._pos + size])
        self._pos += size
        return data

    def _grow(self, needed: int) -> None:
        if needed <= self._capacity:
            return
        if not self._owned:
            raise RuntimeError(
                "MemoryStream: tried to grow a pre-allocated buffer "
                f"({needed} > {self._capacity})")
        new_cap = max(self._capacity * 2, needed, 512)
        self._buf.extend(b"\0" * (new_cap - len(self._buf)))
        self._capacity = new_cap

    def write_bytes(self, data: bytes) -> None:
        _check_open(self)
        end = self._pos + len(data)
        self._grow(end)
        self._buf[self._pos:end] = data
        self._pos = end
        self._size = max(self._size, end)

    def seek(self, pos: int) -> None:
        _check_open(self)
        self._pos = pos     # may exceed size, as in the reference

    def tell(self) -> int:
        _check_open(self)
        return self._pos

    def size(self) -> int:
        return self._size

    def truncate(self, size: int) -> None:
        _check_open(self)
        self._grow(size)
        if size > self._size:
            self._buf[self._size:size] = b"\0" * (size - self._size)
        self._size = size
        self._pos = min(self._pos, size)


class ZStream(Stream):
    """Transparent DEFLATE/GZIP (de)compression over a child stream
    (reference zstream.h/zstream.cpp). Reading inflates from the child's
    current position; writing deflates; ``close`` (or deletion) finishes
    the compressed frame."""

    EDeflateStream = 0
    EGZipStream = 1

    def __init__(self, child: Stream, stream_type: int = EDeflateStream,
                 level: int = -1):
        super().__init__()
        self._child = child
        wbits = 15 if stream_type == self.EDeflateStream else 15 | 16
        self._wbits = wbits
        self._level = level
        self._comp = None
        self._decomp = None
        self._read_buf = b""
        self._pos = 0

    def child_stream(self) -> Stream:
        return self._child

    def can_read(self) -> bool:
        return self._child.can_read()

    def can_write(self) -> bool:
        return self._child.can_write()

    def read_bytes(self, size: int) -> bytes:
        _check_open(self)
        if self._decomp is None:
            self._decomp = zlib.decompressobj(self._wbits)
        while len(self._read_buf) < size:
            avail = self._child.size() - self._child.tell()
            if avail <= 0:
                chunk = self._decomp.flush()
                if not chunk:
                    raise EOFError(
                        f"ZStream: read {len(self._read_buf)}/{size} bytes "
                        "(premature end of compressed stream)")
                self._read_buf += chunk
                continue
            raw = self._child.read_bytes(min(32768, avail))
            self._read_buf += self._decomp.decompress(raw)
        out, self._read_buf = self._read_buf[:size], self._read_buf[size:]
        self._pos += size
        return out

    def write_bytes(self, data: bytes) -> None:
        _check_open(self)
        if self._comp is None:
            self._comp = zlib.compressobj(self._level, zlib.DEFLATED,
                                          self._wbits)
        chunk = self._comp.compress(data)
        if chunk:
            self._child.write_bytes(chunk)
        self._pos += len(data)

    def tell(self) -> int:
        return self._pos

    def size(self) -> int:
        return self._pos

    def seek(self, pos: int) -> None:
        raise RuntimeError("ZStream does not support seeking")

    def truncate(self, size: int) -> None:
        raise RuntimeError("ZStream does not support truncation")

    def flush(self) -> None:
        self._child.flush()

    def close(self) -> None:
        if not self._closed and self._comp is not None:
            tail = self._comp.flush()
            if tail:
                self._child.write_bytes(tail)
            self._child.flush()
        super().close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class DummyStream(Stream):
    """Write-only size/position tracker: full Stream interface, discarded
    payload (reference dstream.cpp) — used to measure serialized sizes."""

    def __init__(self):
        super().__init__()
        self._pos = 0
        self._size = 0

    def can_read(self) -> bool:
        return False

    def can_write(self) -> bool:
        return True

    def read_bytes(self, size: int) -> bytes:
        raise RuntimeError("DummyStream does not support reading")

    def write_bytes(self, data: bytes) -> None:
        _check_open(self)
        self._pos += len(data)
        self._size = max(self._size, self._pos)

    def seek(self, pos: int) -> None:
        _check_open(self)
        self._pos = pos

    def tell(self) -> int:
        return self._pos

    def size(self) -> int:
        return self._size

    def truncate(self, size: int) -> None:
        self._size = size
        self._pos = min(self._pos, size)


class MemoryMappedFile:
    """Read-only or copy-on-write memory mapping (reference mmap.cpp).
    Exposes a zero-copy ``memoryview`` plus numpy helpers."""

    def __init__(self, path, write: bool = False):
        self.path = str(path)
        self._write = write
        self._f = open(self.path, "r+b" if write else "rb")
        self._size = os.fstat(self._f.fileno()).st_size
        access = _mmap.ACCESS_WRITE if write else _mmap.ACCESS_READ
        self._map = _mmap.mmap(self._f.fileno(), self._size, access=access)

    def size(self) -> int:
        return self._size

    def can_write(self) -> bool:
        return self._write

    def data(self) -> memoryview:
        return memoryview(self._map)

    def as_array(self, dtype="u1", offset: int = 0, count: int = -1):
        import numpy as np
        return np.frombuffer(self._map, dtype=dtype, offset=offset,
                             count=count)

    def as_stream(self) -> MemoryStream:
        """A MemoryStream view over the mapping (no copy on read)."""
        return MemoryStream(memoryview(self._map))

    def close(self) -> None:
        if self._map is not None:
            try:
                self._map.close()
            except BufferError:
                pass     # zero-copy views still alive; unmap deferred to GC
            self._f.close()
            self._map = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
