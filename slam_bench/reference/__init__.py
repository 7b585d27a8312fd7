"""The benchmark's plain reference: DROID-SLAM in float32 PyTorch, with no
hand-written kernel and nothing captured.

A frozen copy of the port's plain fused tracking path
(``droid_slam_tpu_torch``'s ``ops``, ``models`` and ``runtime`` modules
as they stood when the benchmark was written, cut to what tracking runs),
so that no later change to the program moves the yardstick. It imports
nothing of the program: its own msgpack reader loads the shipped weights
(``models/msgpack_io.py``, ``models/weights.py``), its own encoders,
correlation lookup, update operator and GraphAgg, and the fused tracking
step (motion filter, keyframe append, graph upkeep and the cull, the
dense-window BA).

Departures from the port's semantics, each one line in the file it
touches:

* ``ops/corr.py``: the lookup ``corr_level`` is its plain version (a
  per-edge correlation volume by batched f32 matmul, then a gather of the
  support and the bilinear blend), on any device;
* ``runtime/droid.py`` and ``runtime/graph.py``: nothing is captured, so
  every step runs eagerly (on the card too, reading each branch's
  predicate on the host); the fused engine only, no ``terminate`` and no
  visualiser.

The benchmark runs it with ``compute_dtype`` float32 and TF32 off, so the
update operator and the stored features are float32 where the program's
configuration states bfloat16. On the CPU, in float32, the reference and
the port's plain path agree bit for bit
(``slam_bench/tests/test_slam_bench_reference.py``).
"""
