"""Compressed graphs: the host codecs (CGR, StreamVByte, VarintGB, hybrid),
their on-disk format and the ``compress`` command, and CGR's decode on the
device (``cgr_device.py``, the kernels K12 of ``csrc/cgr_decode.cu``).

Counterpart of ``graphaibench_tpu/compress/``; the device decoders of
StreamVByte, VarintGB and hybrid (``device_decode.py``, K11) are not ported
yet (ROADMAP queue 2).
"""

from graphaibench_tpu_torch.compress import cgr, hybrid, vbyte  # noqa: F401
from graphaibench_tpu_torch.compress.cli import (  # noqa: F401
    compress_cmd,
    decode_any,
    decompress_cmd,
    load_compressed,
    save_compressed,
    verify_cmd,
)
