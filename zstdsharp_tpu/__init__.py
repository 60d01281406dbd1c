"""zstdsharp_tpu — an accelerator-native Zstandard (RFC 8878) codec framework.

A from-scratch reimplementation of the capabilities of CHeavyarms/ZstdSharp
(itself a port of zstd v1.5.1), designed for the device: JAX/XLA/Pallas kernels
for the data-parallel hot stages over fixed-size blocks, a host layer for
framing/streaming, and `jax.sharding` data parallelism across chips.

Public API (mirrors the reference's L2 surface, Compressor.cs/Decompressor.cs):

    compress(data, level=3) -> bytes
    decompress(data, max_output_size=...) -> bytes
    Compressor, Decompressor
    CompressionStream, DecompressionStream
    train_dictionary(samples, dict_size)
    ZstdError
"""

from .errors import ZstdError, ZstdErrorCode

__version__ = "0.1.0"

__all__ = [
    "ZstdError",
    "ZstdErrorCode",
    "compress",
    "decompress",
    "compress_bound",
    "Compressor",
    "Decompressor",
    "CompressionStream",
    "DecompressionStream",
    "train_dictionary",
    "finalize_dictionary",
    "optimize_train_from_buffer",
    "ZstdCompressionDict",
    "__version__",
]


def __getattr__(name):
    # Lazy imports keep `import zstdsharp_tpu` light (no jax import on the
    # pure-host paths).
    if name in ("decompress", "Decompressor", "frame_info", "decompress_bound"):
        from .decode import frame as _f

        return getattr(_f, name)
    if name in ("compress", "compress_bound", "Compressor"):
        from .encode import frame as _f

        return getattr(_f, name)
    if name in ("CompressionStream", "DecompressionStream"):
        from . import streaming as _s

        return getattr(_s, name)
    if name in ("train_dictionary", "finalize_dictionary",
                "optimize_train_from_buffer", "ZstdCompressionDict"):
        from . import dictionary as _d

        return getattr(_d, name)
    raise AttributeError(name)
