"""Kernel 8's op (flash attention) of the PyTorch/CUDA port against the JAX
reference, on the CPU.

The port's ``flash_attention`` runs its plain version (``attention_ref``)
for CPU tensors; it is held against the reference's ``flash_attention``
(the Pallas kernel in interpret mode) and its oracle ``attention_ref`` at
the reference's own cases (``ATTN_CASES`` of ``tests/test_kernels.py``),
with the same numpy inputs on both sides.  Tolerances are the reference's:
fp32 within 2e-5, bf16 within 3e-2 (the two frameworks round the bf16
logits at their own places).  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_mask as ref_mask
from repro.kernels.flash_attention import attention_ref as ref_attention
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels.flash_attention import attention_mask, attention_ref, flash_attention

TOL = dict(atol=2e-5, rtol=2e-5)

# the reference's ATTN_CASES (tests/test_kernels.py), plus GQA 3:1 at a
# ragged length and d = 32
ATTN_CASES = [
    dict(b=2, h=4, hk=2, sq=256, sk=256, d=64, causal=True, window=None, off=0),
    dict(b=1, h=8, hk=8, sq=300, sk=300, d=64, causal=True, window=None, off=0),
    dict(b=1, h=4, hk=4, sq=256, sk=256, d=128, causal=True, window=64, off=0),
    dict(b=2, h=4, hk=2, sq=1, sk=512, d=64, causal=True, window=None, off=511),
    dict(b=1, h=2, hk=2, sq=1, sk=1024, d=64, causal=True, window=256, off=1023),
    dict(b=1, h=2, hk=2, sq=128, sk=128, d=64, causal=False, window=None, off=0),
    dict(b=1, h=16, hk=16, sq=160, sk=160, d=80, causal=False, window=None, off=0),
    dict(b=2, h=6, hk=2, sq=45, sk=45, d=32, causal=True, window=None, off=0),
]


def _inputs(c, seed, dtype=np.float32):
    r = np.random.default_rng(seed)
    q = r.standard_normal((c["b"], c["h"], c["sq"], c["d"])).astype(dtype)
    k = r.standard_normal((c["b"], c["hk"], c["sk"], c["d"])).astype(dtype)
    v = r.standard_normal((c["b"], c["hk"], c["sk"], c["d"])).astype(dtype)
    return q, k, v


def _kw(c):
    return dict(causal=c["causal"], window=c["window"], q_offset=c["off"])


@pytest.mark.parametrize("i", range(len(ATTN_CASES)))
def test_flash_attention_matches_reference(i):
    c = ATTN_CASES[i]
    q, k, v = _inputs(c, i)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), **_kw(c)).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for ref in (ref_flash(jq, jk, jv, **_kw(c)), ref_attention(jq, jk, jv, **_kw(c))):
        print(f"case {i}: max abs gap {np.abs(got - np.asarray(ref)).max():.3g}")  # pytest -s
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_flash_attention_bf16_matches_reference():
    c = dict(b=1, h=4, hk=4, sq=128, sk=128, d=64, causal=True, window=None, off=0)
    q, k, v = _inputs(c, 7)
    got = flash_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    ref = ref_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=3e-2, rtol=3e-2)


def test_model_layout_views_equal_contiguous_inputs():
    """The model hands the op transposed views of ``[b, s, h, d]``
    activations (GQA 24:8 shape family, cut to 6:2); the answer is the same
    as for contiguous ``[b, h, s, d]`` copies."""
    r = np.random.default_rng(3)
    q = torch.from_numpy(r.standard_normal((2, 33, 6, 32)).astype(np.float32))
    k = torch.from_numpy(r.standard_normal((2, 33, 2, 32)).astype(np.float32))
    v = torch.from_numpy(r.standard_normal((2, 33, 2, 32)).astype(np.float32))
    views = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    copies = flash_attention(*(t.transpose(1, 2).contiguous() for t in (q, k, v)))
    assert not q.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(views, copies, atol=0, rtol=0)
    ref = ref_attention(*(jnp.asarray(t.transpose(1, 2).numpy()) for t in (q, k, v)))
    np.testing.assert_allclose(views.numpy(), np.asarray(ref), **TOL)


def test_row_with_no_visible_key_is_zero_as_in_the_oracle():
    """Non-causal window 4 at q_offset 10 over 16 keys: queries 9-15 see no
    key.  The port gives them 0, the oracle's answer (the reference's Pallas
    kernel gives the mean of the masked v rows there, ROADMAP.md §3 R3)."""
    c = dict(b=1, h=2, hk=2, sq=16, sk=16, d=32, causal=False, window=4, off=10)
    q, k, v = _inputs(c, 11)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), **_kw(c)).numpy()
    ref = np.asarray(ref_attention(*map(jnp.asarray, (q, k, v)), **_kw(c)))
    np.testing.assert_allclose(got, ref, **TOL)
    assert not got[:, :, 9:].any()
    assert np.abs(got[:, :, :9]).max() > 0.1


def test_mask_window_and_plain_path_agree_with_reference():
    for sq, sk, causal, window, off in [(5, 9, True, None, 4), (7, 7, False, 3, 0),
                                        (1, 20, True, 6, 19), (16, 16, False, 4, 10)]:
        np.testing.assert_array_equal(attention_mask(sq, sk, causal, window, off),
                                      ref_mask(sq, sk, causal, window, off))
    r = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(r.standard_normal((1, 2, 128, 32)).astype(np.float32))
               for _ in range(3))
    wide = flash_attention(q, k, v, causal=True, window=4096)
    torch.testing.assert_close(wide, flash_attention(q, k, v, causal=True), atol=1e-6,
                               rtol=0)
    torch.testing.assert_close(flash_attention(q, k, v, use_kernel=False),
                               attention_ref(q, k, v), atol=0, rtol=0)


def test_bad_shapes_raise():
    q = torch.zeros(1, 4, 8, 32)
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q, torch.zeros(1, 3, 8, 32), torch.zeros(1, 3, 8, 32))
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q, torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8, 16))
    with pytest.raises(ValueError, match="shapes"):
        flash_attention(q[0], torch.zeros(2, 8, 32), torch.zeros(2, 8, 32))
