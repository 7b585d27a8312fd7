"""Pay the port's first-use costs once, at install time.

Counterpart of the JAX repo's ``tools/prime_cache.py``. The JAX package
compiles XLA programs per shape and primes a persistent compile cache; the
port compiles nothing per shape. Its first use pays the ``nvcc`` build of
the hand-written kernels (``csrc/``, into the gitignored
``droid_slam_tpu_torch/_build/``, which later processes reuse) and cuDNN's
first calls of the encoders' and the update operator's convolutions (which
last as long as the process). This builds the kernels
(``ops/kernels.py::build``) and runs ``Droid.warm_terminate`` for the
configuration given, then prints what was built and the seconds of each.

  python -m droid_slam_tpu_torch.tools.prime [--image_size 240 320] [--buffer 64] \\
      [--frames 44] [--compute_dtype bfloat16] [--stereo] [--weights W]

It needs ``nvcc`` and a CUDA device: without either it says which is
missing, builds nothing and exits non-zero (the CPU has nothing to prime).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List


def missing() -> List[str]:
    """What this machine lacks for priming: nvcc, a CUDA device."""
    import torch

    from ..ops import kernels

    reasons = []
    try:
        kernels._nvcc()
    except RuntimeError as e:
        reasons.append(str(e))
    if not torch.cuda.is_available():
        reasons.append("no CUDA device (torch.cuda.is_available() is false)")
    return reasons


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image_size", type=int, nargs=2, default=[240, 320])
    ap.add_argument("--buffer", type=int, default=64)
    ap.add_argument("--frames", type=int, default=44,
                    help="the keyframe count warm_terminate's throwaway state holds")
    ap.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--stereo", action="store_true")
    ap.add_argument("--weights", default=None,
                    help="optional weights file (the first-use costs do not depend on the weights)")
    args = ap.parse_args(argv)

    reasons = missing()
    if reasons:
        print("prime: nothing primed: " + "; ".join(reasons), file=sys.stderr)
        return 1

    from ..ops import kernels
    from ..runtime import Droid, DroidConfig

    t0 = time.perf_counter()
    logs = kernels.build()
    print(f"kernels: built {sorted(logs) or 'nothing (already built)'} in {time.perf_counter() - t0:.1f}s "
          f"into {kernels.BUILD_DIR}", flush=True)

    config = DroidConfig(image_size=tuple(args.image_size), buffer=args.buffer,
                         compute_dtype=args.compute_dtype, stereo=args.stereo)
    droid = Droid(config, weights=args.weights)
    n = min(args.frames, args.buffer - 18)  # the filler's batch fits beside them
    t0 = time.perf_counter()
    droid.warm_terminate(expected_keyframes=n)
    print(f"warm_terminate at {n} keyframes (cuDNN's first calls, global BA, one filler batch) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
