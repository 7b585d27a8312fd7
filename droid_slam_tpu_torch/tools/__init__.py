"""The port's counterparts of the JAX repo's entry points outside its
package: the long loop (``longloop``), the backend probe
(``backend_probe``), the in-process sweep (``eval_sweep``), the
multi-process backend (``mp_backend``), the first-use primer (``prime``)
and the EuRoC ground-truth converter (``euroc_groundtruth``). Each runs
with ``python -m droid_slam_tpu_torch.tools.<name>``."""
