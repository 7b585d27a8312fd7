"""Point-cloud visualisation and export (PyTorch).

Counterpart of the JAX package's ``utils/visualization.py`` (the
reference's visualization.py): keep the pixels that at least 2 neighbour
keyframes see at a consistent depth and whose disparity is above half their
frame's mean (visualization.py:96-111), back-project them, and export them
(PLY and the camera trajectory, no dependency) or hand them to a live
viewer. The computation runs on the video's device. The Open3D window is
optional: open3d is imported only where a window is asked for.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import lie
from ..ops.vis_ops import depth_filter, iproj_points


@torch.no_grad()
def consistent_points(video, filter_thresh: float = 0.005, min_count: float = 2.0):
    """Every pixel of the video's keyframes as (points [t, h, w, 3] f32,
    colors [t, h, w, 3] uint8, mask [t, h, w] bool): the world point, the
    stored image's colour at the 1/8 grid, and whether the pixel passes the
    consistency filter. The neighbours of the count are the t keyframes
    themselves."""
    t = video.counter
    poses = video.poses[:t]
    disps = video.disps[:t]
    intr = video.intrinsics[0]
    h, w = disps.shape[1:]
    inds = torch.arange(t, device=disps.device)
    # a constant threshold, as the reference's (visualization.py:102); the
    # mean disparity enters the mask below
    thresh = torch.full((t,), filter_thresh, device=disps.device)
    counts = depth_filter(poses, disps, intr, inds, thresh)
    mask = (counts >= min_count) & (disps > 0.5 * disps.mean(dim=(1, 2), keepdim=True))
    points = iproj_points(poses, disps, intr)
    colors = video.images[:t, 3::8, 3::8][:, :h, :w]
    return points.cpu().numpy(), colors.cpu().numpy(), mask.cpu().numpy()


def filtered_point_cloud(video, filter_thresh: float = 0.005,
                         min_count: float = 2.0) -> Tuple[np.ndarray, np.ndarray]:
    """(points [M, 3], colors [M, 3] uint8) of the consistent map."""
    if video.counter == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.uint8)
    points, colors, mask = consistent_points(video, filter_thresh, min_count)
    return points[mask], colors[mask]


# wireframe camera: apex, image plane and an "up" tick (visualization.py:14-25)
_CAM_POINTS = np.array(
    [[0, 0, 0], [-1, -1, 1.5], [1, -1, 1.5], [1, 1, 1.5], [-1, 1, 1.5], [-0.5, 1, 1.5],
     [0.5, 1, 1.5], [0, 1.2, 1.5]],
    np.float64,
)
_CAM_LINES = np.array(
    [[1, 2], [2, 3], [3, 4], [4, 1], [1, 0], [0, 2], [3, 0], [0, 4], [5, 7], [7, 6]], np.int32
)


def camera_frusta(poses_w2c: np.ndarray, scale: float = 0.05) -> Tuple[np.ndarray, np.ndarray]:
    """Wireframe frusta of all keyframe cameras as one line set
    (visualization.py:38-45): poses_w2c [T, 7] world→camera (t, q_xyzw) →
    (points [T·8, 3] float64, lines [T·10, 2] int32)."""
    T = len(poses_w2c)
    mats = lie.to_matrix(lie.inv(torch.as_tensor(np.asarray(poses_w2c, np.float32)))).numpy()
    pts = mats[:, :3, :3] @ (scale * _CAM_POINTS).T + mats[:, :3, 3:4]  # [T, 3, 8]
    pts = pts.transpose(0, 2, 1).reshape(T * 8, 3)
    lines = (_CAM_LINES[None] + 8 * np.arange(T)[:, None, None]).reshape(-1, 2)
    return pts, lines.astype(np.int32)


def save_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None) -> None:
    """ASCII PLY of the points, with their colours when given."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    header = ["ply", "format ascii 1.0", f"element vertex {len(points)}",
              "property float x", "property float y", "property float z"]
    rows, fmt = np.asarray(points, np.float64).reshape(-1, 3), "%.6f %.6f %.6f"
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
        rows, fmt = np.column_stack([rows, np.asarray(colors).reshape(-1, 3)]), fmt + " %d %d %d"
    with open(path, "w") as f:
        f.write("\n".join(header + ["end_header"]) + "\n")
        np.savetxt(f, rows, fmt=fmt)


def export_map(video, path: str, filter_thresh: float = 0.005) -> int:
    """Write the filtered map (``map.ply``) and the keyframes'
    camera-to-world poses (``poses_c2w.npy``) into the directory ``path``;
    returns the number of points."""
    points, colors = filtered_point_cloud(video, filter_thresh)
    save_ply(os.path.join(path, "map.ply"), points, colors)
    t = video.counter
    np.save(os.path.join(path, "poses_c2w.npy"), lie.inv(video.poses[:t]).cpu().numpy())
    return len(points)


class VisualizerThread:
    """Live map visualisation beside tracking (the reference's visualiser
    process, droid.py:37-40, visualization.py:60-159).

    A daemon thread polls the video's ``dirty`` flags and, when some
    keyframe changed, recomputes the consistent point cloud and the camera
    frusta and hands the cloud to ``sink(points, colors)``; ``.latest``
    holds the newest cloud. With ``open_window`` and open3d importable it
    also draws them in an Open3D window, else it stays headless. Its work
    is queued on the thread's current CUDA stream, the default stream, so it
    runs between tracking's kernels. With the fused engine each poll first
    copies the viewed buffers of the tracked state
    (``Droid._sync_fused_state(view_only=True)``), which waits for the
    queued tracking work: keep ``refresh_hz`` low.
    """

    def __init__(self, droid, refresh_hz: float = 2.0, sink=None, open_window: bool = False,
                 filter_thresh: float = 0.005):
        self.droid = droid
        self.refresh_hz = refresh_hz
        self.sink = sink
        self.open_window = open_window
        self.filter_thresh = filter_thresh
        self.latest: Tuple[np.ndarray, np.ndarray] = (np.zeros((0, 3)), np.zeros((0, 3), np.uint8))
        self.latest_frusta: Tuple[np.ndarray, np.ndarray] = (np.zeros((0, 3)),
                                                             np.zeros((0, 2), np.int32))
        self.updates = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="droid-visualizer", daemon=True)
        self._thread.start()

    def _refresh(self, video) -> None:
        video.dirty[: video.counter] = False
        self.latest = filtered_point_cloud(video, self.filter_thresh)
        self.latest_frusta = camera_frusta(video.poses[: video.counter].cpu().numpy())
        self.updates += 1
        if self.sink is not None:
            self.sink(*self.latest)

    def _poll_once(self) -> bool:
        droid = self.droid
        if droid.fused:
            droid._sync_fused_state(view_only=True)
        video = droid.video
        if video.counter == 0 or not video.dirty[: video.counter].any():
            return False
        self._refresh(video)
        return True

    def scale_filter(self, factor: float) -> None:
        """Scale the consistency threshold and force a redraw (the
        reference's S (×2) and A (×0.5) keys, visualization.py:68-76)."""
        self.filter_thresh *= factor
        video = self.droid.video
        if video is not None:
            video.dirty[: video.counter] = True

    def _open_window(self):
        """(window, point cloud, frusta) of Open3D, or None without open3d
        or a display."""
        try:
            import open3d as o3d
        except ImportError:
            return None
        try:
            vis = o3d.visualization.VisualizerWithKeyCallback()
            vis.register_key_callback(ord("S"), lambda v: self.scale_filter(2.0))
            vis.register_key_callback(ord("A"), lambda v: self.scale_filter(0.5))
            if not vis.create_window(height=540, width=960):
                return None
        except RuntimeError:
            return None
        return vis, o3d.geometry.PointCloud(), o3d.geometry.LineSet()

    def _draw(self, window, added: bool) -> None:
        import open3d as o3d

        vis, geom, cams = window
        points, colors = self.latest
        geom.points = o3d.utility.Vector3dVector(points)
        geom.colors = o3d.utility.Vector3dVector(colors / 255.0)
        fpts, flines = self.latest_frusta
        cams.points = o3d.utility.Vector3dVector(fpts)
        cams.lines = o3d.utility.Vector2iVector(flines)
        cams.paint_uniform_color((1.0, 0.0, 0.0))
        for g in (geom, cams):
            (vis.update_geometry if added else vis.add_geometry)(g)

    @torch.no_grad()
    def _run(self) -> None:
        window = self._open_window() if self.open_window else None
        added = False
        fail_streak = 0
        while not self._stop.is_set():
            try:
                updated = self._poll_once()
                fail_streak = 0
            except Exception:
                # tracking may be mid-edit: retry at the next tick, but say
                # so when it keeps failing rather than go quiet
                updated = False
                fail_streak += 1
                if fail_streak == 5:
                    print("visualizer: poll failing repeatedly:")
                    traceback.print_exc()
            if window is not None:
                if updated:
                    self._draw(window, added)
                    added = True
                if not window[0].poll_events():
                    break
                window[0].update_renderer()
            self._stop.wait(1.0 / self.refresh_hz)
        if window is not None:
            window[0].destroy_window()

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout)

    def final_update(self) -> None:
        """One refresh from the current video, after the poller stopped:
        ``Droid.terminate`` calls it after global BA, so consumers see the
        optimised map. It reads the video as it is and does not copy the
        fused state, which would bring back the tracked poses."""
        video = self.droid.video
        if video.counter > 0:
            self._refresh(video)


def droid_visualization(video, refresh_hz: float = 10.0) -> None:
    """Live Open3D viewer loop over the video's dirty flags
    (visualization.py:60-159); needs open3d and a display."""
    try:
        import open3d as o3d
    except ImportError as e:
        raise ImportError("open3d is not installed; use export_map() for an offline export") from e
    import time

    vis = o3d.visualization.Visualizer()
    vis.create_window(height=540, width=960)
    geom = o3d.geometry.PointCloud()
    added = False
    while True:
        if video.dirty[: video.counter].any():
            video.dirty[: video.counter] = False
            points, colors = filtered_point_cloud(video)
            geom.points = o3d.utility.Vector3dVector(points)
            geom.colors = o3d.utility.Vector3dVector(colors / 255.0)
            (vis.update_geometry if added else vis.add_geometry)(geom)
            added = True
        if not vis.poll_events():
            break
        vis.update_renderer()
        time.sleep(1.0 / refresh_hz)
