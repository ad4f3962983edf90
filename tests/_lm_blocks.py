"""Block-by-block checks of an LM entry point, for configurations too deep to
compare whole in fp32 (``tests/test_torch_lm_families.py``,
``tests/test_torch_cuda.py``).

``recorded(module)`` records every block call an entry point makes through
``module``'s globals (the port's ``repro_torch.models.transformer`` or the
reference's ``repro.models.transformer``), as numpy copies taken before the
call (decode updates its caches in place) and after it.  ``replay`` runs
each recorded call again through the port's block function, on a device,
and holds its outputs against the recorded ones.
"""

import contextlib

import numpy as np
import torch

BLOCKS = ("attention_block", "mamba_block", "_mamba_prefill", "moe_block", "mlp_block",
          "decode_attention_block", "decode_mamba_block")


def to_numpy(v):
    """Numpy copies of every array in a nest of dicts and tuples."""
    if isinstance(v, dict):
        return {k: to_numpy(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return tuple(to_numpy(x) for x in v)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy().copy()
    if hasattr(v, "shape"):  # a jax array
        return np.array(v)
    return v


def to_torch(v, device):
    if isinstance(v, dict):
        return {k: to_torch(x, device) for k, x in v.items()}
    if isinstance(v, tuple):
        return tuple(to_torch(x, device) for x in v)
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v.copy()).to(device)
    return v


def leaves(v):
    if isinstance(v, (tuple, list)):
        return [x for e in v for x in leaves(e)]
    return [v]


@contextlib.contextmanager
def recorded(module):
    """Yields the list of ``(name, params, args, kwargs, outputs)`` of every
    block call made through ``module`` inside the ``with``."""
    calls = []
    saved = {n: getattr(module, n) for n in BLOCKS}

    def wrap(name, fn):
        def call(p, cfg, *args, **kw):
            before = (to_numpy(p), to_numpy(args), dict(kw))
            out = fn(p, cfg, *args, **kw)
            calls.append((name, *before, to_numpy(out)))
            return out
        return call

    for name, fn in saved.items():
        setattr(module, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def replay(calls, cfg, device, tol, kwargs=lambda kw: kw) -> float:
    """Every recorded call again through the port's block function on
    ``device``, from the recorded parameters and inputs (``kwargs`` maps
    the recorded keyword arguments to the port's), against the recorded
    outputs at atol = rtol = ``tol``.  Returns the largest gap."""
    import repro_torch.models.transformer as tt

    worst = 0.0
    with torch.inference_mode():
        for i, (name, p, args, kw, out) in enumerate(calls):
            got = getattr(tt, name)(to_torch(p, device), cfg, *to_torch(args, device),
                                    **kwargs(kw))
            for g, want in zip(leaves(got), leaves(out), strict=True):
                g = g.cpu().numpy()
                np.testing.assert_allclose(g, want, atol=tol, rtol=tol,
                                           err_msg=f"block call {i} ({name})")
                worst = max(worst, float(np.abs(g - want).max()) if g.size else 0.0)
    return worst
