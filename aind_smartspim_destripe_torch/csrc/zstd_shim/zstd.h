/*
 * Declarations of the part of the zstd 1.5 API that the blosc runtime codec
 * (csrc/destripe_runtime.cpp at the repository root) calls, so that it
 * builds against the libzstd.so.1 runtime alone, on hosts that ship no
 * development header. The enum values are zstd's stable ABI values
 * (zstd.h of release 1.5.x); the frames are identical to a build against
 * the full header.
 */
#ifndef DESTRIPE_ZSTD_SHIM_H
#define DESTRIPE_ZSTD_SHIM_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct ZSTD_CCtx_s ZSTD_CCtx;
typedef struct ZSTD_DCtx_s ZSTD_DCtx;

typedef enum {
  ZSTD_c_compressionLevel = 100,
  ZSTD_c_experimentalParam5 = 1002
} ZSTD_cParameter;
#define ZSTD_c_literalCompressionMode ZSTD_c_experimentalParam5

typedef enum {
  ZSTD_ps_auto = 0,
  ZSTD_ps_enable = 1,
  ZSTD_ps_disable = 2
} ZSTD_paramSwitch_e;

typedef enum {
  ZSTD_reset_session_only = 1,
  ZSTD_reset_parameters = 2,
  ZSTD_reset_session_and_parameters = 3
} ZSTD_ResetDirective;

unsigned ZSTD_isError(size_t code);
size_t ZSTD_compress(void* dst, size_t dstCapacity, const void* src,
                     size_t srcSize, int compressionLevel);
size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src,
                       size_t compressedSize);
ZSTD_CCtx* ZSTD_createCCtx(void);
size_t ZSTD_freeCCtx(ZSTD_CCtx* cctx);
ZSTD_DCtx* ZSTD_createDCtx(void);
size_t ZSTD_freeDCtx(ZSTD_DCtx* dctx);
size_t ZSTD_CCtx_reset(ZSTD_CCtx* cctx, ZSTD_ResetDirective reset);
size_t ZSTD_CCtx_setParameter(ZSTD_CCtx* cctx, ZSTD_cParameter param,
                              int value);
size_t ZSTD_compress2(ZSTD_CCtx* cctx, void* dst, size_t dstCapacity,
                      const void* src, size_t srcSize);
size_t ZSTD_decompressDCtx(ZSTD_DCtx* dctx, void* dst, size_t dstCapacity,
                           const void* src, size_t srcSize);

#ifdef __cplusplus
}
#endif

#endif /* DESTRIPE_ZSTD_SHIM_H */
