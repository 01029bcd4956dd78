"""Compressed graphs: the host codecs (CGR, StreamVByte, VarintGB, hybrid),
their on-disk format and the ``compress`` command, and their decode on the
device: CGR's (``cgr_device.py``, the kernels K12 of ``csrc/cgr_decode.cu``)
and the byte codecs' (``device_decode.py``, the kernels K11 of
``csrc/vbyte_decode.cu``, hybrid's low-degree rows through K12).

Counterpart of ``graphaibench_tpu/compress/``.
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
from graphaibench_tpu_torch.compress.device_decode import (  # noqa: F401
    decode_graph_device,
    decode_hybrid_device,
    streamvbyte_decode_device,
    varintgb_decode_device,
    varintgb_device_prep,
    varintgb_device_run,
)
