"""Runtime-described memory layouts + converter (host-side).

Rebuild of the reference's Struct / StructConverter
(reference include/mitsuba/core/struct.h, src/core/struct.cpp — there an
asmjit x86 JIT; here vectorized numpy, which IS the fast bulk-conversion
engine on the host). Drives bitmap pixel-format conversion and any
user-described binary record translation.

Supported semantics (struct.h:47-92 flags):
  * Normalized — integer fields map to [0, 1] floats on load and back
  * Gamma      — field is sRGB-gamma-encoded; converting to a linear field
                 applies the exact IEC 61966-2-1 curve (and inversely)
  * Default    — a missing source field fills with the default value
  * Assert     — source field must equal the default (validation)
  * PremultipliedAlpha / Alpha — converting between pre- and
                 non-premultiplied representations divides/multiplies by
                 the alpha channel
  * byte order — big/little per struct; conversion swaps as needed
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = ["FieldFlags", "Struct", "StructConverter", "srgb_to_linear",
           "linear_to_srgb"]


class FieldFlags:
    Empty = 0x00
    Normalized = 0x01
    Gamma = 0x02
    Assert = 0x04
    Default = 0x08
    Weight = 0x10
    PremultipliedAlpha = 0x20
    Alpha = 0x40


_TYPES = {
    "uint8": np.uint8, "int8": np.int8,
    "uint16": np.uint16, "int16": np.int16,
    "uint32": np.uint32, "int32": np.int32,
    "uint64": np.uint64, "int64": np.int64,
    "float16": np.float16, "float32": np.float32, "float64": np.float64,
}


def srgb_to_linear(x):
    """Exact IEC 61966-2-1 decoding (reference struct.cpp gamma path)."""
    x = np.asarray(x, np.float64)
    return np.where(x <= 0.04045, x / 12.92,
                    ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x):
    x = np.asarray(x, np.float64)
    x = np.clip(x, 0.0, None)
    return np.where(x <= 0.0031308, x * 12.92,
                    1.055 * x ** (1.0 / 2.4) - 0.055)


class _Field:
    __slots__ = ("name", "dtype", "flags", "default", "offset")

    def __init__(self, name, dtype, flags, default, offset):
        self.name = name
        self.dtype = np.dtype(dtype)
        self.flags = flags
        self.default = default
        self.offset = offset

    def is_integer(self):
        return np.issubdtype(self.dtype, np.integer)

    def range(self):
        """Representable range (reference struct.h Field::range)."""
        if self.is_integer():
            info = np.iinfo(self.dtype)
            return float(info.min), float(info.max)
        return -np.inf, np.inf


class Struct:
    """An ordered field layout (reference struct.h:141+). Fields pack
    sequentially; ``append`` returns self for chaining."""

    class Type:
        """Component-format aliases used by Bitmap.convert
        (reference Struct::Type)."""
        UInt8 = __import__("numpy").uint8
        Int8 = __import__("numpy").int8
        UInt16 = __import__("numpy").uint16
        Int16 = __import__("numpy").int16
        UInt32 = __import__("numpy").uint32
        Int32 = __import__("numpy").int32
        Float16 = __import__("numpy").float16
        Float32 = __import__("numpy").float32
        Float64 = __import__("numpy").float64

    def __init__(self, pack: bool = True, byte_order: str = "little"):
        if byte_order not in ("little", "big", "host"):
            raise ValueError(f"invalid byte order '{byte_order}'")
        if byte_order == "host":
            import sys
            byte_order = sys.byteorder
        self.byte_order = byte_order
        self.fields: List[_Field] = []
        self._size = 0

    def append(self, name: str, dtype, flags: int = FieldFlags.Empty,
               default: Optional[float] = None) -> "Struct":
        if isinstance(dtype, str):
            dtype = _TYPES[dtype]
        f = _Field(name, dtype, flags, default, self._size)
        self.fields.append(f)
        self._size += f.dtype.itemsize
        return self

    def field(self, name: str) -> _Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def has_field(self, name: str) -> bool:
        return any(f.name == name for f in self.fields)

    def field_names(self):
        return [f.name for f in self.fields]

    @property
    def size(self) -> int:
        return self._size

    @property
    def alignment(self) -> int:
        return max((f.dtype.itemsize for f in self.fields), default=1)

    def dtype(self) -> np.dtype:
        """The numpy structured dtype of one record."""
        bo = "<" if self.byte_order == "little" else ">"
        return np.dtype({
            "names": [f.name for f in self.fields],
            "formats": [f.dtype.newbyteorder(bo) for f in self.fields],
            "offsets": [f.offset for f in self.fields],
            "itemsize": self._size})

    def __repr__(self):
        rows = ", ".join(f"{f.name}:{f.dtype.name}@{f.offset}"
                         for f in self.fields)
        return f"Struct[{self.byte_order}, size={self._size}, {rows}]"


def _to_float(field: _Field, col: np.ndarray) -> np.ndarray:
    out = col.astype(np.float64)
    if field.is_integer() and (field.flags & FieldFlags.Normalized):
        lo, hi = field.range()
        if lo < 0:                      # signed normalized: [-1, 1]
            out = np.maximum(out / hi, -1.0)
        else:
            out = out / hi
    if field.flags & FieldFlags.Gamma:
        out = srgb_to_linear(out)
    return out


def _from_float(field: _Field, lin: np.ndarray) -> np.ndarray:
    out = lin
    if field.flags & FieldFlags.Gamma:
        out = linear_to_srgb(out)
    if field.is_integer() and (field.flags & FieldFlags.Normalized):
        lo, hi = field.range()
        out = np.clip(out, -1.0 if lo < 0 else 0.0, 1.0) * hi
    if field.is_integer():
        lo, hi = field.range()
        out = np.clip(np.rint(out), lo, hi)
    return out.astype(field.dtype)


class StructConverter:
    """Bulk record converter (reference StructConverter, struct.cpp).
    ``convert(data, count)`` translates packed source records to packed
    destination records, field-matched by name."""

    def __init__(self, source: Struct, target: Struct):
        self.source = source
        self.target = target

    def convert(self, data: bytes, count: Optional[int] = None) -> bytes:
        src_dt = self.source.dtype()
        if count is None:
            if len(data) % src_dt.itemsize:
                raise ValueError("buffer size is not a record multiple")
            count = len(data) // src_dt.itemsize
        rec = np.frombuffer(data, dtype=src_dt, count=count)

        # linear float view of every source field
        lin: Dict[str, np.ndarray] = {}
        for f in self.source.fields:
            lin[f.name] = _to_float(f, rec[f.name])
            if f.flags & FieldFlags.Assert and f.default is not None:
                if not np.allclose(rec[f.name].astype(np.float64),
                                   f.default):
                    raise ValueError(
                        f"field '{f.name}' failed assert == {f.default}")

        # alpha handling (struct.h:87-92): convert premultiplied <-> not
        src_alpha = next((f for f in self.source.fields
                          if f.flags & FieldFlags.Alpha), None)
        alpha = lin.get(src_alpha.name) if src_alpha is not None else None

        out = np.zeros(count, dtype=self.target.dtype())
        for f in self.target.fields:
            if f.name in lin:
                v = lin[f.name]
                sf = self.source.field(f.name)
                spre = bool(sf.flags & FieldFlags.PremultipliedAlpha)
                dpre = bool(f.flags & FieldFlags.PremultipliedAlpha)
                if alpha is not None and spre != dpre:
                    if spre:            # unpremultiply
                        v = np.where(alpha > 0, v / np.maximum(alpha, 1e-30),
                                     0.0)
                    else:
                        v = v * alpha
            elif f.default is not None or (f.flags & FieldFlags.Default):
                v = np.full(count, 0.0 if f.default is None else f.default)
            else:
                raise ValueError(
                    f"target field '{f.name}' missing from source and has "
                    "no default")
            out[f.name] = _from_float(f, np.asarray(v))
        return out.tobytes()


