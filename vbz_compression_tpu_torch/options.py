"""Compression options — the single runtime config object of the codec (the
port's own copy of ``vbz_compression_tpu.options``).

Mirrors ``CompressionOptions`` from the reference C ABI (``vbz/vbz.h:29-53``):

- ``perform_delta_zig_zag`` — delta + zig-zag transform before variable-byte packing.
- ``integer_size`` — 0 (raw bytes), 1, 2 or 4; selects the variable-int width.
- ``zstd_compression_level`` — 0 disables the zstd stage.
- ``vbz_version`` — 0 (classic StreamVByte codes) or 1 (half-byte codes for
  ``integer_size == 1``; 2/4-byte widths delegate to v0,
  reference: ``vbz/v1/vbz_streamvbyte.cpp:46-61,91-109``).

The HDF5 filter serializes this as ``cd_values = [version, integer_size,
zigzag, zstd_level]`` (reference: ``vbz_plugin/vbz_plugin.h:7-10``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .errors import VBZ_INTEGER_SIZE_ERROR, VBZ_VERSION_ERROR, VbzError

VBZ_DEFAULT_VERSION = 0

VALID_INTEGER_SIZES = (0, 1, 2, 4)


@dataclasses.dataclass(frozen=True)
class CompressionOptions:
    perform_delta_zig_zag: bool = True
    integer_size: int = 2
    zstd_compression_level: int = 1
    vbz_version: int = VBZ_DEFAULT_VERSION

    def validate(self) -> "CompressionOptions":
        # Reference: is_valid_integer_size, vbz/vbz.cpp:44-50.
        if self.integer_size not in VALID_INTEGER_SIZES:
            raise VbzError(VBZ_INTEGER_SIZE_ERROR, f"integer_size={self.integer_size}")
        return self

    def validate_version(self) -> "CompressionOptions":
        # Reference: version dispatch, vbz/vbz.cpp:139-151.
        if self.vbz_version not in (0, 1):
            raise VbzError(VBZ_VERSION_ERROR, f"vbz_version={self.vbz_version}")
        return self

    @property
    def cd_values(self) -> tuple[int, int, int, int]:
        """HDF5 filter parameter encoding (reference: ``vbz_plugin/vbz_plugin.h:7-10``)."""
        return (
            self.vbz_version,
            self.integer_size,
            int(self.perform_delta_zig_zag),
            self.zstd_compression_level,
        )

    @classmethod
    def from_cd_values(cls, cd_values) -> "CompressionOptions":
        """Parse HDF5 ``cd_values``; the zstd level defaults to 1 when only 3
        values are present (reference: ``vbz_plugin/vbz_plugin.cpp:109-124``)."""
        if len(cd_values) < 3:
            raise ValueError("vbz filter requires at least 3 cd_values")
        level = cd_values[3] if len(cd_values) > 3 else 1
        return cls(
            perform_delta_zig_zag=bool(cd_values[2]),
            integer_size=int(cd_values[1]),
            zstd_compression_level=int(level),
            vbz_version=int(cd_values[0]),
        )

    @classmethod
    def for_dtype(cls, dtype, zstd_compression_level: int = 1,
                  vbz_version: int = VBZ_DEFAULT_VERSION) -> "CompressionOptions":
        """Infer options from a numpy dtype the way pyvbz does: signed dtypes
        get zig-zag, the width comes from itemsize
        (reference: ``python/pyvbz/vbz/__init__.py:23-25``)."""
        dt = np.dtype(dtype)
        return cls(
            perform_delta_zig_zag=bool(np.issubdtype(dt, np.signedinteger)),
            integer_size=dt.itemsize,
            zstd_compression_level=zstd_compression_level,
            vbz_version=vbz_version,
        )


def compression_options(zigzag, size, zlevel=1, version=0) -> CompressionOptions:
    """pyvbz-compatible constructor (reference: ``python/pyvbz/vbz/__init__.py:12-18``)."""
    return CompressionOptions(
        perform_delta_zig_zag=bool(zigzag),
        integer_size=int(size),
        zstd_compression_level=int(zlevel),
        vbz_version=int(version),
    )
