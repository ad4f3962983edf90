"""``attn_roofline``: the least time attention's work could
take on the card, max(operations / bf16 peak, bytes / HBM peak) with the
operations 4 b h s s d (halved when causal) and q, k, v and the output
moved once each, over the device time of the kernels that compute it:
kernel 8 (``flash_attention*``) or PyTorch's own attention kernels, so that
the share reads the same work whatever implements it."""

from portbench.flops import attention

KERNELS = ("flash_attention", "flash_fwd", "fmha", "efficient_attention", "cudnn_sdpa",
           "scaled_dot_product")


def read(t):
    if t.kind != "prefill" or not t.n_units:
        return None
    s = t.device_s(KERNELS)
    if s is None:
        return None
    b, n = int(t.traffic["batch"]), int(t.traffic["seq_len"])
    least = max(attention.core(t.cfg, b, n) / t.peaks["bf16_flops"],
                attention.core_bytes(t.cfg, b, n) / t.peaks["hbm_bytes_per_s"])
    return 100.0 * least * t.n_units / s
