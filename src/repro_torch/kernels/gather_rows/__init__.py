"""Row gather for the device feature cache (``csrc/gather_rows.cu``)."""

from repro_torch.kernels.gather_rows.ops import (  # noqa: F401
    gather_rows,
    gather_rows_cfg,
    gather_rows_ref,
)
