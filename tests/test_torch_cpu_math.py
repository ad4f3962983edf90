"""The port's CPU vector math is settled before an entry point computes.

torch's CPU ``sqrt`` (and ``exp``, ``log``, ``tanh`` ...) reach MKL's vector
math library, which picks its code path on its first call.  When that first
call is a parallel one, one OpenMP thread's chunk can come back from a
low-accuracy path (a ``sqrt`` good to 12 bits).  A spawned data-parallel
rank whose first such call was its first Adam update drifted from rank 0
(``test_torch_scale_out.py::test_dp_fit_local_runs_through_fit``, now and
then under load).  ``resolve_device``, which every entry point calls first,
makes one serial call before anything else.

  * ``resolve_device`` settles the math once, whatever the device;
  * in fresh processes started side by side, the first parallel ``sqrt``
    after ``resolve_device("cpu")`` is correctly rounded to within 1 ulp.

Run as a script to count the bad first calls with and without the settling
call (``python tests/test_torch_cpu_math.py --processes 240 --load 8``).
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch import device as device_mod

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# a fresh interpreter's first parallel sqrt (12,288 elements: six chunks of
# torch's 2,048-element grain), held to numpy's correctly rounded one
CHILD = """
import sys
import numpy as np
import torch
if sys.argv[1] == "settled":
    from repro_torch.device import resolve_device
    resolve_device("cpu")
x = np.random.default_rng(int(sys.argv[2])).random(12288).astype(np.float32) * 1e-6
got = torch.sqrt(torch.from_numpy(x)).numpy().astype(np.float64)
want = np.sqrt(x).astype(np.float64)
print(float(np.max(np.abs(got - want) / want)))
"""


def _first_sqrt_errors(mode: str, processes: int, parallel: int = 8):
    """The worst relative error of the first parallel ``sqrt`` in each of
    ``processes`` fresh interpreters, ``parallel`` of them at a time."""
    env = dict(os.environ, PYTHONPATH=SRC)
    errors = []
    for start in range(0, processes, parallel):
        procs = [subprocess.Popen([sys.executable, "-c", CHILD, mode, str(seed)], env=env,
                                  stdout=subprocess.PIPE, text=True)
                 for seed in range(start, min(processes, start + parallel))]
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0
            errors.append(float(out.strip().splitlines()[-1]))
    return errors


def test_resolve_device_settles_cpu_math_once(monkeypatch):
    calls = []
    real_sqrt = torch.sqrt
    monkeypatch.setattr(device_mod, "_cpu_math_settled", False)
    monkeypatch.setattr(torch, "sqrt", lambda t: calls.append(t.numel()) or real_sqrt(t))
    device_mod.resolve_device("cpu")
    device_mod.resolve_device("cpu")
    assert calls == [1]
    assert device_mod._cpu_math_settled


def test_first_parallel_sqrt_after_resolve_device_is_accurate():
    errors = _first_sqrt_errors("settled", processes=8)
    assert max(errors) <= 2 ** -23, errors  # 1 ulp; the bad path is off by up to 3e-4


def _burn(seconds: float) -> None:
    import time

    x = np.random.rand(300, 300)
    t = time.time()
    while time.time() - t < seconds:
        x = x @ x
        x /= np.abs(x).max()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--processes", type=int, default=240)
    ap.add_argument("--load", type=int, default=8, help="single-threaded busy processes beside")
    args = ap.parse_args()
    import multiprocessing as mp

    os.environ["OMP_NUM_THREADS"] = "1"  # the busy processes only
    burners = [mp.get_context("spawn").Process(target=_burn, args=(3600.0,), daemon=True)
               for _ in range(args.load)]
    for b in burners:
        b.start()
    del os.environ["OMP_NUM_THREADS"]
    try:
        for mode in ("cold", "settled"):
            errs = np.array(_first_sqrt_errors(mode, args.processes))
            print(f"{mode}: {int((errs > 2 ** -23).sum())} of {errs.size} first parallel sqrt calls "
                  f"off by more than 1 ulp (worst {errs.max():.3e})")
    finally:
        for b in burners:
            b.terminate()
