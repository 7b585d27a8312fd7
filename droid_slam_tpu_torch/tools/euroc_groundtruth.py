"""Convert EuRoC MAV ground truth to the TUM trajectory format.

Counterpart of the JAX repo's ``tools/euroc_groundtruth.py``: reads a
sequence's ``mav0/state_groundtruth_estimate0/data.csv`` (or a ``.csv``
named directly) with :meth:`..eval.ate.Trajectory.load_euroc_csv` and
writes it as TUM text (t, xyz, q_xyzw), by default beside the CSV as
``groundtruth_tum.txt``. ``apps/evaluate.py --dataset euroc`` reads the
CSV itself; this is for other tools.

  python -m droid_slam_tpu_torch.tools.euroc_groundtruth datasets/EuRoC/MH_01_easy [out.txt]
"""

from __future__ import annotations

import os
import sys


def convert(seq: str, out: str = None) -> str:
    """Write ``seq``'s ground truth as TUM text; returns the path written."""
    from ..eval.ate import Trajectory

    csv = seq if seq.endswith(".csv") else os.path.join(seq, "mav0", "state_groundtruth_estimate0", "data.csv")
    if out is None:
        out = os.path.join(os.path.dirname(csv), "groundtruth_tum.txt")
    traj = Trajectory.load_euroc_csv(csv)
    traj.save_tum(out)
    print(f"{len(traj.tstamps)} poses -> {out}")
    return out


def main(argv=None) -> str:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        sys.exit(__doc__)
    return convert(argv[0], argv[1] if len(argv) > 1 else None)


if __name__ == "__main__":
    main()
