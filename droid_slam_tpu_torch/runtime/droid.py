"""Droid: the SLAM system facade of the port.

Counterpart of the JAX package's ``runtime/droid.py``: ``track()`` runs the
motion filter and the frontend for one input frame (monocular, RGB-D or a
stereo pair) on the tracking device; ``terminate()`` runs the global
backend twice (7 then 12 steps) and returns the keyframe trajectory, or
with a stream the trajectory of every frame. Two tracking engines share the
math and the state layout:

* ``fused=True`` (default): the per-frame step of :mod:`.fused`, all state
  in one device structure. On a CUDA device, from the first frame after
  initialisation on, each frame is one replay of a CUDA graph of the step
  (:class:`.graph.CapturedStep`), with its branches as conditional nodes:
  no host read. ``capture=False`` runs the same step eagerly, reading each
  branch's predicate on the host (at most 3 reads per frame); it is the
  plain version the graph is held against. The CPU is always eager.
  ``terminate`` works on a copy of the tracked state, so it may run more
  than once;
* ``fused=False``: the host-driven engine with the reference's per-stage
  objects (:class:`.motion_filter.MotionFilter`,
  :class:`.frontend.DroidFrontend` and its :class:`.factor_graph.FactorGraph`)
  over a live :class:`.video.VideoState`, about three blocking reads per
  frame; ``terminate`` runs on that video, once.

``capture`` also covers every factor graph the Droid makes: the host
engine's frontend, both global-BA passes of ``terminate`` and of
``warm_terminate``, and the trajectory filler. On a CUDA device each of
their operator steps whose static key has been seen is one CUDA graph
replay (:meth:`.factor_graph.FactorGraph.update`, ``update_lowmem``);
``capture=False`` runs them eagerly. With ``ba_mesh`` the global BA's
steps run eagerly either way.

``visualize=True`` starts a :class:`..utils.visualization.VisualizerThread`
(an Open3D window where open3d imports, headless otherwise). ``ba_mesh``, a
``torch.distributed`` process group, runs terminate's global BA
edge-sharded over its ranks (:mod:`..parallel.sharded_ba`); every rank
tracks the same frames, and since the port's kernels repeat bit for bit the
ranks' replicated states stay identical.
"""

from __future__ import annotations

import copy
import warnings
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..models.droid_net import DroidNet, init_params
from ..models.weights import load_weights
from ..ops import lie
from . import fused as fused_step
from .backend import DroidBackend
from .config import DroidConfig
from .factor_graph import CaptureStats
from .frontend import DroidFrontend
from .graph import CapturedStep
from .motion_filter import MotionFilter
from .trajectory_filler import PoseTrajectoryFiller
from .video import VideoState, _depth_to_disp_sens

# what the visualiser's point cloud reads of the fused state
_VIEW_BUFFERS = ("tstamp", "images", "poses", "disps", "intrinsics")
_TRACKING_BUFFERS = ("disps_sens", "fmaps", "nets", "inps")


def resolve_device(device=None) -> torch.device:
    """The tracking device: CUDA unless the caller names another. Without a
    CUDA device and without an explicit device this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "droid_slam_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return torch.device("cuda")


class Droid:
    """Per-frame tracking, global BA and trajectory fill at the end.

    ``params`` is a state dict for :class:`DroidNet` (from
    :func:`..models.weights.params_from_jax` or :func:`init_params`);
    without it, ``weights`` names a weights file
    (:func:`..models.weights.load_weights`: the JAX package's ``.msgpack``
    or a reference ``.pth``); with neither, random ``init_params(0)``.
    ``fused`` picks the tracking engine (module docstring); ``capture``
    (CUDA only) replays the fused step after initialisation and the factor
    graphs' steps as CUDA graphs, ``capture=False`` runs them eagerly. The
    host engine
    keeps the JAX package's dtypes: f32 encoders, probe, video features and
    per-edge hidden state, with only the update operator in
    ``config.compute_dtype``. ``ba_mesh`` (optional) is a
    ``torch.distributed`` process group whose backend carries ``device``:
    terminate's global BA then runs sharded over its ranks (the JAX
    package's mesh with a ``"ba"`` axis).
    """

    def __init__(
        self,
        config: DroidConfig,
        params: Optional[Dict[str, torch.Tensor]] = None,
        weights: Optional[str] = None,
        device=None,
        fused: bool = True,
        capture: bool = True,
        ba_mesh=None,
        visualize: bool = False,
        vis_refresh_hz: float = 2.0,
    ):
        self.config = config
        self.device = resolve_device(device)
        self.ba_mesh = ba_mesh
        if params is None:
            params = load_weights(weights) if weights is not None else init_params(0)
        net = DroidNet()
        net.load_state_dict(params)
        self.net = net.to(self.device).eval()
        cdt = getattr(torch, config.compute_dtype)
        self._update_op = (
            self.net.update if cdt == torch.float32 else copy.deepcopy(self.net.update).to(cdt)
        )
        self.fused = fused
        self.capture = bool(capture) and self.device.type == "cuda"
        # host copy of the state's is_init, read after each frame until init ran
        self._initialized = False
        # the captured steady-state step, made on the first frame after init
        self.graph: Optional[CapturedStep] = None
        if fused:
            self._state = fused_step.init_state(config, self.device)
            self._track_step = fused_step.build_track_step(self.net, config)
            self.video: Optional[VideoState] = None  # copied out by terminate and the visualiser
        else:
            self.video = VideoState(config, self.device)
            self.filterx = MotionFilter(self.net, self.video, thresh=config.filter_thresh)
            self.frontend = DroidFrontend(self._update_op, self.video, config, capture=self.capture)
        # (edges, update-operator chunks per step) of terminate's two
        # global-BA passes, and what the last terminate's captured steps
        # cost and ran (its passes and its fill)
        self.backend_runs: List[Tuple[int, int]] = []
        self.terminate_stats = CaptureStats()

        self.visualizer = None
        if visualize:
            from ..utils.visualization import VisualizerThread

            self.visualizer = VisualizerThread(self, refresh_hz=vis_refresh_hz, open_window=True)

    @torch.no_grad()
    def track(self, tstamp, image, depth=None, intrinsics=None) -> None:
        """Track one frame: image [H, W, 3] (or [1, H, W, 3]) uint8 RGB, in
        stereo the pair [2, H, W, 3] (left, right); intrinsics [4] at full
        resolution, optional depth [H, W]."""
        img = torch.as_tensor(image, device=self.device)
        if img.dim() == 3:
            img = img[None]
        rig = 2 if self.config.stereo else 1
        if img.dim() != 4 or img.shape[0] != rig:
            raise ValueError(f"expected {rig} image(s) [H, W, 3] per frame, got {tuple(img.shape)}")
        intr = torch.as_tensor(intrinsics, dtype=torch.float32, device=self.device)
        if not self.fused:
            dep = None if depth is None else torch.as_tensor(depth, device=self.device)
            self.filterx.track(float(tstamp), img, dep, intr)
            self.frontend()
            return
        h, w = self.config.feat_size
        if depth is not None:
            sens = _depth_to_disp_sens(torch.as_tensor(depth, device=self.device), h, w)
        else:
            sens = torch.zeros((h, w), device=self.device)
        st = self._state
        if self._initialized and self.capture:
            if self.graph is None:
                self.graph = CapturedStep(self._track_step, st, tstamp, img, intr, sens)
            self.graph(tstamp, img, intr, sens)
            return
        ts = torch.full((), float(tstamp), device=self.device)
        self._track_step(st, ts, img, intr, sens, initialized=self._initialized)
        if not self._initialized:
            self._initialized = bool(st.is_init)

    def sync(self) -> None:
        """Block until the queued tracking work has finished on the device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- read access to the tracking state (either engine) ----

    def _buffers(self):
        return self._state if self.fused else self.video

    @property
    def counter(self) -> int:
        """Number of keyframes (a host read of the fused state's count)."""
        return int(self._buffers().counter)

    @property
    def tstamps(self) -> torch.Tensor:
        return self._buffers().tstamp[: self.counter]

    @property
    def poses(self) -> torch.Tensor:
        """World→camera keyframe poses [counter, 7] as (t, q_xyzw)."""
        return self._buffers().poses[: self.counter]

    @property
    def disps(self) -> torch.Tensor:
        """Keyframe inverse depths [counter, h, w] at 1/8 resolution."""
        return self._buffers().disps[: self.counter]

    @staticmethod
    def _edge_set(ii, jj, valid) -> Set[Tuple[int, int]]:
        return {(int(i), int(j)) for i, j, v in zip(ii.tolist(), jj.tolist(), valid.tolist()) if v}

    @property
    def edges(self) -> Set[Tuple[int, int]]:
        """Active factor-graph edges (i, j) of the tracking engine."""
        if self.fused:
            st = self._state
            return self._edge_set(st.ii, st.jj, st.valid)
        g = self.frontend.graph
        return self._edge_set(g.ii, g.jj, g.valid)

    @property
    def inactive_edges(self) -> Set[Tuple[int, int]]:
        """Edges retired to the inactive store."""
        if self.fused:
            st = self._state
            return self._edge_set(st.inac_ii, st.inac_jj, st.inac_valid)
        g = self.frontend.graph
        return self._edge_set(g.ii_inac, g.jj_inac, g.valid_inac)

    def _sync_fused_state(self, view_only: bool = False) -> VideoState:
        """Copy the fused engine's tracked state into a fresh
        :class:`VideoState` with every keyframe marked dirty. The buffers
        are copies, not aliases: terminate may run more than once, and each
        run starts again from the tracked state. ``view_only`` copies just
        what the visualiser's point cloud reads (poses, disps, images,
        tstamp, intrinsics), not the features."""
        st = self._state
        v = VideoState.__new__(VideoState)  # no default buffers: all are copied in
        v.config = self.config
        v.counter = int(st.counter)
        if v.counter >= st.poses.shape[0] and not view_only:
            warnings.warn(
                f"keyframe buffer saturated ({v.counter}/{st.poses.shape[0]}): later "
                "keyframes were dropped; rerun with a larger DroidConfig.buffer",
                RuntimeWarning,
            )
        for name in _VIEW_BUFFERS + (() if view_only else _TRACKING_BUFFERS):
            setattr(v, name, getattr(st, name).clone())
        v.disps_up = st.disps_up.clone() if self.config.upsample else None
        v.dirty = np.zeros(st.poses.shape[0], bool)
        v.dirty[: v.counter] = True
        self.video = v
        return v

    @torch.no_grad()
    def warm_terminate(self, expected_keyframes: Optional[int] = None) -> None:
        """Pay terminate's first-use costs ahead of time, on a throwaway
        state: the global BA (with ``ba_mesh`` if one was given) and one
        trajectory-filler batch on a video of ``expected_keyframes``
        keyframes (default: the buffer less 2, clamped to [2, buffer − 2])
        with jittered poses, so proximity selection fills the same 16·t
        edge budget as a long session. The live state is not touched.

        The JAX package's counterpart precompiles XLA programs of the
        quantised shapes. The port compiles nothing per shape; its first
        use pays the nvcc build of the kernels (``ops/kernels.py``, seconds
        per source on a cold build directory) and cuDNN's first calls of
        the update operator's and the encoder's convolutions, which this
        warms. One backend pass of 2 steps runs what the 7- and 12-step
        passes run."""
        cfg = self.config
        t = cfg.buffer - 2 if expected_keyframes is None else int(expected_keyframes)
        t = min(max(t, 2), cfg.buffer - 2)
        v = VideoState(cfg, self.device)
        v.counter = t
        rng = np.random.default_rng(0)
        tw = np.cumsum(0.01 * rng.standard_normal((cfg.buffer, 6)), 0).astype(np.float32)
        v.poses.copy_(lie.retr(v.poses, torch.from_numpy(tw).to(self.device)))
        h, w = cfg.feat_size
        v.intrinsics[:] = torch.tensor([1.2 * w, 1.2 * w, w / 2, h / 2], device=self.device)
        DroidBackend(self._update_op, v, cfg, mesh=self.ba_mesh, capture=self.capture)(2)
        batch = min(16, cfg.buffer - t)
        if batch >= 1:
            v.tstamp.copy_(torch.arange(cfg.buffer, dtype=torch.float32, device=self.device))
            H, W = cfg.image_size
            intr_full = np.asarray([1.2 * W, 1.2 * W, W / 2, H / 2], np.float32)
            dummy = np.zeros((H, W, 3), np.uint8)
            stream = [(k + 0.5, dummy, intr_full) for k in range(batch)]
            PoseTrajectoryFiller(self.net, self._update_op, v, cfg, capture=self.capture)(iter(stream))
        self.sync()

    @torch.no_grad()
    def terminate(self, stream=None) -> np.ndarray:
        """Global BA (7 then 12 steps) and, with ``stream`` (yielding
        (tstamp, image, intrinsics) for every frame), the trajectory fill.
        Returns camera-to-world poses [T, 7] as (t, q_xyzw): the keyframes'
        without a stream, every stream frame's with one. The fused engine
        works on a copy of its state; the host engine retires its frontend
        and optimises its live video."""
        # stop the visualiser before global BA: in fused mode its poll would
        # replace the video with the tracked state between backend steps
        if self.visualizer is not None:
            self.visualizer.close()
        # the captured step's graph and pools go before the global BA needs
        # the memory; tracking after terminate captures anew
        self.graph = None
        if self.fused:
            v = self._sync_fused_state()
        else:
            del self.frontend
            v = self.video
        backend = DroidBackend(self._update_op, v, self.config, mesh=self.ba_mesh, capture=self.capture)
        self.backend_runs = [backend(7), backend(12)]
        self.terminate_stats = backend.stats
        # one refresh of the optimised map for the visualiser's consumers
        if self.visualizer is not None:
            self.visualizer.final_update()
        if stream is not None:
            filler = PoseTrajectoryFiller(self.net, self._update_op, v, self.config, capture=self.capture)
            traj = filler(stream)
            self.terminate_stats.merge(filler.stats)
            return traj
        return lie.inv(v.poses[: v.counter]).cpu().numpy()
