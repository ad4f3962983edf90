"""``gather_backward_ms.train``: device ms a traced training step of the
backward of the MoE dispatch gather (``h[gather_idx]`` in
``repro_torch/models/moe.py``), by the names of the kernels that run it."""

KERNELS = ("indexing_backward_kernel",)


def read(t):
    if t.kind != "train" or not t.n_units:
        return None
    s = t.device_s(KERNELS)
    return None if s is None else s / t.n_units * 1e3
