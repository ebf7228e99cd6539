// CUDA-graph conditional (IF) nodes for programs.cond: the counterpart of
// lax.cond inside a captured program.
//
// graph_if_begin, called while ``stream`` is being captured, appends to
// the captured graph a one-thread kernel that sets a conditional handle
// from the bool at ``pred`` (negated when ``negate`` is nonzero) and,
// after it, an IF node on that handle; the capture of ``stream`` goes on
// after the IF node.  It then starts capturing ``body`` (an idle stream)
// into the IF node's body graph: the work launched on ``body`` until
// graph_if_end runs on a replay only where the condition held.  A body
// may hold further IF nodes (the same two calls with ``body`` as the
// capturing stream).
#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred, int negate) {
  cudaGraphSetConditional(handle, (*pred ? 1u : 0u) ^ (negate ? 1u : 0u));
}

cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* ndeps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                             deps, nullptr, ndeps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                             deps, ndeps);
#endif
  if (err == cudaSuccess && status != cudaStreamCaptureStatusActive) {
    return cudaErrorStreamCaptureInvalidated;
  }
  return err;
}

}  // namespace

extern "C" int graph_if_begin(const void* pred, int negate, void* body,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = capture_info(s, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred),
                                negate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the IF node depends on the kernel just captured
  err = capture_info(s, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed);
}

extern "C" int graph_if_end(void* stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &body);
}
