"""The analytic upload-size model and the codec names specs may carry.

Copy of what the API layer needs from `repro.net.codecs`: the codec
registry's names (for spec validation) and `analytic_upload_bytes`.  The
codecs themselves are not ported yet; `api.compile_plan` raises
NotImplementedError for any codec other than "analytic"."""
from __future__ import annotations

CODEC_NAMES = ("dense_f32", "sparse_coo", "sparse_bitpack")
SPARSE_BITPACK_VALUE_BITS = (8, 16, 32)


def analytic_upload_bytes(n_params: int, ratio: float,
                          bytes_per_value: int = 4,
                          bytes_per_index: int = 4) -> int:
    """Dense f32 values, or (value, index) pairs for a sparsified upload."""
    if ratio >= 1.0:
        return int(n_params) * bytes_per_value
    return int(n_params * ratio) * (bytes_per_value + bytes_per_index)
