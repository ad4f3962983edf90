"""What the reference implements of a configuration's ``run_as``: every
key, with the values that the reference and the adapter both run.  A cell,
the adapter and the reference refuse any other, so that a configuration
added as files is never run as something it does not state."""

from __future__ import annotations


class RunAsError(ValueError):
    """A ``run_as`` key or value that the benchmark does not implement."""


# every key of a configuration's ``run_as``, with the values that both the
# adapter and the reference implement (``float`` for any number); a key
# left out, a key not named here, or another value is refused
RUN_AS = {"family": str, "causal": (True, False), "decoder": (True, False),
          "frontend": (None, "audio"), "ffn": ("moe", "mlp"), "mlp": ("gated_silu",),
          "norm": ("rms",), "head": ("untied",), "multipliers": ("none",),
          "capacity_factor": float, "rope_fraction": float, "rope_theta": float,
          "norm_eps": float, "params_dtype": ("bfloat16", "float32")}


def check_run_as(cfg: dict) -> dict:
    """The configuration's ``run_as``, once every key and value is one that
    the benchmark implements."""
    run = cfg.get("run_as")
    if not isinstance(run, dict):
        raise RunAsError(f"{cfg.get('name')}: no run_as")
    if set(run) != set(RUN_AS):
        raise RunAsError(f"{cfg.get('name')}: run_as keys {sorted(run)}; the benchmark "
                         f"implements exactly {sorted(RUN_AS)}")
    for k, allowed in RUN_AS.items():
        v = run[k]
        if allowed is float:
            good = isinstance(v, (int, float)) and not isinstance(v, bool)
        elif allowed is str:
            good = isinstance(v, str)
        else:
            good = any(v is a if a is None or isinstance(a, bool) else v == a for a in allowed)
        if not good:
            raise RunAsError(f"{cfg.get('name')}: run_as {k}={v!r} is not implemented "
                             f"(implemented: {allowed})")
    return run
