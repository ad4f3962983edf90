"""Published dense peaks of the cards the benchmark runs on (NVIDIA's data
sheet for the H100 SXM, without sparsity), keyed by a part of the name that
``torch.cuda.get_device_name()`` gives."""

PEAKS = {
    "H100": {"bf16_flops": 989e12, "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(kind: str) -> dict:
    for key, p in PEAKS.items():
        if key in kind:
            return p
    raise KeyError(f"no published peaks for {kind!r}")
