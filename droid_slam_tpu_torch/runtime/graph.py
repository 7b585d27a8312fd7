"""The fused step's branches, and the step captured as one CUDA graph.

:func:`cond` is the port's ``lax.cond``: the fused tracking step
(:mod:`.fused`) takes each of its branches through it, and each branch
writes its results into the state's own storage. It runs in one of three
modes:

* eager (the default, and always on the CPU): it reads the predicate once
  on the host and runs one branch. These reads are the only ones the
  steady-state step makes: at most 3 per frame (keyframe, update, cull);
* warm-up (inside :func:`_warming`): it runs the true branch, then the
  false one, so that every operation of either side has run once before a
  capture (cuDNN's and cuBLAS's first calls, the kernels' builds);
* capture (inside :class:`Captured`): it reads nothing. It adds an IF node
  on the predicate around the true branch and an IF node on its negation
  around the false branch (``csrc/graph_cond.cu``), all in the graph
  itself (a nested cond is flattened, see :class:`_Capture`). The bodies
  are captured on a stream of their own, their allocations routed to a
  memory pool that lives as long as the graph.

:class:`Captured` captures a function into one graph; :class:`CapturedStep`
captures the steady-state fused step (after initialisation) once and
replays it for every later frame: one graph launch and no host read per
frame. A failed capture raises; nothing falls back to the eager step.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
from typing import Callable, Dict, List, Optional

import torch

from ..ops import kernels

Tensor = torch.Tensor

_STREAMS: Dict[int, List[torch.cuda.ExternalStream]] = {}  # device → [the graph's stream, the bodies' stream]
_WARMING: Optional[list] = None  # during a warm-up: the streams its branches run on (empty on the CPU)
_CAPTURE: Optional["_Capture"] = None


def cond(pred: Tensor, true_fn: Callable, false_fn: Optional[Callable], operand) -> None:
    """``true_fn(operand)`` where the 0-dim bool ``pred`` holds, else
    ``false_fn(operand)`` (nothing if it is None). Both write their results
    into ``operand`` in place; neither returns anything."""
    if _CAPTURE is not None:
        _CAPTURE.cond(pred, true_fn, false_fn, operand)
    elif _WARMING is not None:
        _warm_branch(true_fn, operand)
        if false_fn is not None:
            _warm_branch(false_fn, operand)
    elif bool(pred):
        true_fn(operand)
    elif false_fn is not None:
        false_fn(operand)


@contextlib.contextmanager
def _warming(device: Optional[torch.device] = None):
    """Run both sides of every :func:`cond` (a warm-up before a capture).
    On a CUDA ``device`` the code inside runs on the graph's stream and
    each branch on the bodies' stream, as in a capture, so that no library
    meets a stream for the first time during the capture."""
    global _WARMING
    on_card = device is not None and device.type == "cuda"
    _WARMING = _streams(kernels.library("graph_cond"), device) if on_card else []
    try:
        if on_card:
            with _on_stream(_WARMING[0]):
                yield
        else:
            yield
    finally:
        _WARMING = None


@contextlib.contextmanager
def _on_stream(stream):
    """Run on ``stream``, ordered after the current stream's work and
    before its later work."""
    parent = torch.cuda.current_stream(stream.device)
    stream.wait_stream(parent)
    with torch.cuda.stream(stream):
        yield
    parent.wait_stream(stream)


def _warm_branch(fn: Callable, operand) -> None:
    if _WARMING:
        with _on_stream(_WARMING[1]):
            fn(operand)
    else:  # the CPU
        fn(operand)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")


def _streams(lib, device: torch.device) -> List[torch.cuda.ExternalStream]:
    """This device's two non-blocking capture streams (the graph's, and
    the one every IF body is captured on), made once per process."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _STREAMS:
        _check(lib.graph_cond_load(), "graph_cond_load")
        made = []
        with torch.cuda.device(index):
            for _ in range(2):
                ptr = ctypes.c_void_p()
                _check(lib.graph_stream_create(ctypes.byref(ptr)), "graph_stream_create")
                made.append(torch.cuda.ExternalStream(ptr.value, device=torch.device("cuda", index)))
        _STREAMS[index] = made
    return _STREAMS[index]


class _Capture:
    """What :func:`cond` does while a graph is being captured.

    Every IF node sits in the graph itself, none inside another's body: a
    cond met inside a body (cull / keep inside update) closes that body,
    adds IF nodes on outer ∧ pred and outer ∧ ¬pred for its branches, then
    opens a new IF node on the outer predicate for the rest of the outer
    body. (With IF nodes nested in a body, the CUDA driver faulted at the end of
    the inner body's capture on the card this was written for, where the
    inner body held cuDNN's FFT convolutions of a float32 step.)"""

    def __init__(self, lib, streams, pool):
        self.lib = lib
        self.device = streams[0].device
        self.main, self.body = streams
        self.pool = pool
        self.outer: Optional[Tensor] = None  # the open body's predicate
        self.preds: List[Tensor] = []  # read on every replay
        self.branch_launches: Dict[str, Dict[str, int]] = {}

    def cond(self, pred: Tensor, true_fn: Callable, false_fn: Optional[Callable], operand) -> None:
        if pred.dtype != torch.bool or pred.dim() != 0 or pred.device != self.device:
            raise ValueError(f"cond: the predicate must be a 0-dim bool on {self.device}, got "
                             f"{pred.dtype} {tuple(pred.shape)} on {pred.device}")
        outer = self.outer
        if outer is not None:
            self._end()  # the outer body up to here
        self.preds.append(pred)
        with torch.cuda.stream(self.main):
            branches = [(pred, true_fn, ""), (torch.logical_not(pred), false_fn, "not ")]
            if outer is not None:
                branches = [(torch.logical_and(outer, p), fn, tag) for p, fn, tag in branches]
        for p, fn, tag in branches:
            if fn is None:
                continue
            self._begin(p)
            before = kernels.launch_counts()
            try:
                if outer is None:
                    with torch.cuda.stream(self.body):
                        torch._C._cuda_beginAllocateCurrentStreamToPool(self.device.index, self.pool)
                        try:
                            fn(operand)
                        finally:
                            torch._C._cuda_endAllocateToPool(self.device.index, self.pool)
                            torch._C._cuda_releasePool(self.device.index, self.pool)
                else:  # already on the bodies' stream, its allocations routed
                    fn(operand)
            finally:
                self._end()
            self.branch_launches[tag + fn.__name__] = kernels.launches_since(before)
        if outer is not None:
            self._begin(outer)  # the rest of the outer body

    def _begin(self, pred: Tensor) -> None:
        """An IF node on ``pred`` after the graph's work so far, whose body
        the bodies' stream captures from here."""
        self.preds.append(pred)
        with torch.cuda.stream(self.main):
            kernels.launch("graph_cond", self.device, pred.data_ptr(), self.body.cuda_stream)
        self.outer = pred

    def _end(self) -> None:
        if self.outer is not None:  # (not after a failed inner branch)
            self.outer = None
            _check(self.lib.graph_if_end(self.body.cuda_stream), "ending an IF node's body")


class Captured:
    """``fn()`` captured into one CUDA graph on ``device``, its
    :func:`cond` branches as IF nodes; ``replay()`` runs it on the current
    stream. ``fn`` must have run inside :func:`_warming` on the same device
    before (both sides of every branch, on the streams the capture uses),
    and must write its results into storage that outlives the graph.

    ``capture_s`` is the capture's wall time, ``pool_bytes`` the device
    memory it reserved (the intermediates in the graph's pool and in the
    bodies' pool), ``launches`` the kernel launches captured (every branch),
    ``branch_launches`` those of each branch's body (nested bodies
    included, its own IF node's set kernel not), and ``replays`` the
    replays so far. A failed capture raises."""

    def __init__(self, fn: Callable[[], None], device: torch.device):
        device = torch.device("cuda", device.index if device.index is not None else torch.cuda.current_device())
        lib = kernels.library("graph_cond")
        streams = _streams(lib, device)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        with torch.cuda.device(device):
            self._pool = torch.cuda.MemPool()  # the IF bodies' allocations
        capture = _Capture(lib, streams, self._pool.id)
        self.graph = torch.cuda.CUDAGraph()
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        global _CAPTURE
        _CAPTURE = capture
        try:
            with torch.cuda.graph(self.graph, stream=streams[0], capture_error_mode="thread_local"):
                fn()
        except Exception as e:
            raise RuntimeError("capturing into a CUDA graph failed") from e
        finally:
            _CAPTURE = None
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.launches = kernels.launches_since(before)
        self.branch_launches = capture.branch_launches
        self._preds = capture.preds
        self.replays = 0

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1


class CapturedStep(Captured):
    """The steady-state fused step as one CUDA graph.

    ``step(st, tstamp, image, intrinsics, disp_sens, initialized=True)`` is
    the fused step; ``st`` its initialised state, on a CUDA device. The
    constructor copies the frame into static input buffers, runs the step
    once with both sides of every :func:`cond` on a clone of the state (the
    warm-up, on the capture's streams; the clone is discarded), then
    captures the step on ``st``. It does not run the frame: the caller
    replays for it. Each call copies a frame into the buffers (``copy_`` on
    the device; a host array is uploaded first, which waits for the copy)
    and replays the graph on the current stream. The graph, its pools and
    its buffers go with the object.
    """

    def __init__(self, step: Callable, st, tstamp: float, image: Tensor, intrinsics: Tensor,
                 disp_sens: Tensor):
        device = st.poses.device
        self.inputs = (torch.full((), float(tstamp), device=device), image.clone(), intrinsics.clone(),
                       disp_sens.clone())
        with _warming(device):
            step(st.clone(), *self.inputs, initialized=True)
        storage = st.storage()
        super().__init__(lambda: step(st, *self.inputs, initialized=True), device)
        if st.storage() != storage:
            moved = sorted(k for k, p in st.storage().items() if storage[k] != p)
            raise RuntimeError(f"the captured step rebound state buffers {moved}: replays would not see them")

    def __call__(self, tstamp: float, image: Tensor, intrinsics: Tensor, disp_sens: Tensor) -> None:
        ts, img, intr, sens = self.inputs
        ts.fill_(float(tstamp))
        img.copy_(image)
        intr.copy_(intrinsics)
        sens.copy_(disp_sens)
        self.replay()
