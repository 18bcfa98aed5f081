// graph_cond: the conditional node under repro_torch.core.compiled.cond, the
// port's counterpart of lax.cond inside a captured step.
//
// Replaces no TPU kernel.  The JAX package's gates (htree.gated_check,
// htree.apply_splits, the AMRules expansion gate) are lax.conds that XLA
// compiles into the step's program, so the branch not taken costs nothing
// and the host never reads the predicate.  A CUDA graph holds the same only
// through a conditional node (CUDA 12.3 and later): the graph launches the
// node, the node runs one of its body graphs, and which one is decided on
// the device by a value that a kernel upstream in the graph sets.
//
// graph_cond_open(stream, pred, bodies): `stream` is capturing a graph.
// Captures a one-thread kernel that sets the node's condition from the bool
// at `pred` each time the graph runs, then adds the conditional node after
// it and makes the stream depend on the node.  bodies[0] receives the graph
// run when *pred is true, bodies[1] the graph run when it is false.  With
// CUDA 12.8 and later that is one IF node with an ELSE body; before, two IF
// nodes in a row, the second on the negated condition.
// graph_body_begin(stream, body) / graph_body_end(stream): capture what is
// launched on `stream` into a body graph, which may hold further
// conditional nodes (the nested gate of htree.gated_check).
//
// Cost per gate in the graph: the one-thread kernel (two conditions before
// 12.8) and the node's launch of the body taken; nothing of the body not
// taken runs.  Each entry point returns a cudaError_t, 0 on success.

#include <cuda_runtime.h>

namespace {

__global__ void set_conditions(cudaGraphConditionalHandle taken,
                               cudaGraphConditionalHandle other,
                               const bool* pred, int two) {
  const unsigned v = *pred ? 1u : 0u;
  cudaGraphSetConditional(taken, v);
  if (two) cudaGraphSetConditional(other, 1u - v);
}

cudaError_t add_if(cudaStream_t stream, cudaGraph_t graph,
                   cudaGraphConditionalHandle handle, unsigned size,
                   cudaGraph_t* bodies) {
  cudaStreamCaptureStatus status;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph,
                                             &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = size;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  for (unsigned i = 0; i < size; ++i) bodies[i] = params.conditional.phGraph_out[i];
  return cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                             cudaStreamSetCaptureDependencies);
}

}  // namespace

extern "C" int graph_cond_open(void* stream, const void* pred, void** bodies) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(st, &status, nullptr, &graph);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle taken, other = 0;
  err = cudaGraphConditionalHandleCreate(&taken, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
#if CUDART_VERSION >= 12080
  const int two = 0;
#else
  const int two = 1;
  err = cudaGraphConditionalHandleCreate(&other, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
#endif
  set_conditions<<<1, 1, 0, st>>>(taken, other, (const bool*)pred, two);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t* out = (cudaGraph_t*)bodies;
#if CUDART_VERSION >= 12080
  return (int)add_if(st, graph, taken, 2, out);
#else
  err = add_if(st, graph, taken, 1, out);
  if (err != cudaSuccess) return (int)err;
  return (int)add_if(st, graph, other, 1, out + 1);
#endif
}

extern "C" int graph_body_begin(void* stream, void* body) {
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)stream, (cudaGraph_t)body, nullptr, nullptr, 0,
      cudaStreamCaptureModeRelaxed);
}

extern "C" int graph_body_end(void* stream) {
  cudaGraph_t body = nullptr;
  return (int)cudaStreamEndCapture((cudaStream_t)stream, &body);
}
