"""droid_slam_tpu_torch — the PyTorch + CUDA port of droid_slam_tpu.

A second package beside the JAX reference ``droid_slam_tpu``: the same
semantics and public layouts (NHWC features, (t, q_xyzw) poses), on an
NVIDIA Hopper GPU, with hand-written CUDA kernels where the JAX package had
Pallas kernels. It imports nothing of JAX or of the JAX package.

Entry point: :class:`droid_slam_tpu_torch.runtime.Droid`.
"""
