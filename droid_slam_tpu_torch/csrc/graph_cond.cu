// IF nodes for a captured CUDA graph: the port's lax.cond inside one
// device program per frame.
//
// Replaces no Pallas kernel. The JAX package's fused tracking step
// (droid_slam_tpu/runtime/fused.py:564-759) is one jitted program whose
// branches (keyframe append, init/update, keyframe cull) are lax.conds on
// device scalars. The port captures its step into a CUDA graph
// (runtime/graph.py) and turns each branch into a conditional node whose
// body runs or not on the card, from a device scalar, with no host read.
// PyTorch's own IF-node capture (CUDAGraph.begin_capture_to_if_node) is
// missing from the PyTorch on the card this was written for, so the node
// is built here with the runtime's graph API (CUDA 12.4 or later).
//
// graph_if_begin(pred, body, stream): ``stream`` is capturing into a graph
// G. It creates a conditional handle on G, captures a one-thread kernel
// that sets the handle from the byte *pred, adds an IF node after that
// kernel, makes the node the stream's only capture dependency and starts
// capturing stream ``body`` into the node's body graph. graph_if_end(body) ends that capture (an
// empty body gets an empty node); what the caller enqueued on ``body`` in
// between runs on replay only where the predicate held. No IF/ELSE node:
// an else branch is a second IF node on the negated predicate, as
// PyTorch's own helper does. The port puts every IF node in G itself,
// none in another's body (runtime/graph.py says why).
//
// Bound: the kernel reads one byte and sets one handle per replay; its
// cost is a launch inside the graph (about a microsecond), not bytes or
// operations.

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle, const unsigned char* pred) {
  cudaGraphSetConditional(handle, *pred != 0 ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t stream, cudaStreamCaptureStatus* status, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n_deps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps, nullptr, n_deps);
#else
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps, n_deps);
#endif
}

}  // namespace

// Load the set kernel's module now, outside any capture (lazy loading
// would otherwise load it while the first IF node is captured).
extern "C" int graph_cond_load() {
  cudaFuncAttributes attr;
  return static_cast<int>(cudaFuncGetAttributes(&attr, set_conditional_kernel));
}

// A stream for capture, the caller's alone (PyTorch hands its pooled
// streams to other code too), non-blocking: it never joins the legacy
// default stream, so other threads' work there cannot invalidate a capture.
extern "C" int graph_stream_create(void** out) {
  cudaStream_t s = nullptr;
  const cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = s;
  return static_cast<int>(err);
}

extern "C" int graph_if_begin(const void* pred, void* body, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = capture_info(stream, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorIllegalState;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;
  set_conditional_kernel<<<1, 1, 0, stream>>>(handle, static_cast<const unsigned char*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = capture_info(stream, &status, &graph, &deps, &n_deps);  // now ending at the kernel
  if (err != cudaSuccess) return err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

extern "C" int graph_if_end(void* body) {
  cudaGraph_t graph;
  cudaError_t err = cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph);
  if (err != cudaSuccess) return err;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess || n > 0) return err;
  cudaGraphNode_t empty;
  return cudaGraphAddEmptyNode(&empty, graph, nullptr, 0);
}
