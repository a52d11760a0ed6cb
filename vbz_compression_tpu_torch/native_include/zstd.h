/* The part of libzstd's stable C ABI that native/vbz_native.cpp calls.
 *
 * The port builds native/ against the system's <zstd.h> where it is
 * installed. A machine that has the runtime library (libzstd.so.1) but no
 * development header gets this file on the include path instead, and the
 * library links against libzstd.so.1 by name
 * (vbz_compression_tpu_torch/utils/_native_build.py). Every declaration
 * below is in the stable section of zstd.h since v1.3.0, so it matches any
 * libzstd.so.1 from then on. native/h5z_abi.h does the same for HDF5's
 * filter ABI.
 */
#ifndef VBZ_PORT_ZSTD_ABI_H
#define VBZ_PORT_ZSTD_ABI_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

#define ZSTD_CONTENTSIZE_UNKNOWN (0ULL - 1)
#define ZSTD_CONTENTSIZE_ERROR (0ULL - 2)

size_t ZSTD_compress(void *dst, size_t dstCapacity, const void *src,
                     size_t srcSize, int compressionLevel);
size_t ZSTD_decompress(void *dst, size_t dstCapacity, const void *src,
                       size_t compressedSize);
unsigned long long ZSTD_getFrameContentSize(const void *src, size_t srcSize);
size_t ZSTD_compressBound(size_t srcSize);
unsigned ZSTD_isError(size_t code);

#ifdef __cplusplus
}
#endif

#endif /* VBZ_PORT_ZSTD_ABI_H */
