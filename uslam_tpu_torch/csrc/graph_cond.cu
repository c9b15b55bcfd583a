// Conditional nodes of a CUDA graph: `lax.while_loop` and `lax.cond` on the
// device.
//
// Replaces no Pallas kernel. The JAX package's compiled programs branch and
// loop on device values: the LM is a `lax.while_loop` (uslam_tpu/solvers/
// lm.py:229-233) whose step re-linearizes under `lax.cond` (:178-181), and
// its CG solve is another `lax.while_loop` (uslam_tpu/solvers/schur.py:
// 316-350). XLA keeps these on the device. A CUDA graph captured by PyTorch
// has fixed control flow, so the port adds the graph's conditional nodes
// (CUDA 12.4+): a WHILE node, whose body runs while its handle is 1, and an
// IF node with an else body (CUDA 12.8+). Their handles are set on the device
// from a 0-d bool tensor by the kernel below, so a graph that loops or
// branches never waits on the host.
//
// The host half (uslam_tpu_torch/solvers/compiled.py) calls, while a graph is
// being captured on `stream`:
// - uslam_cond_node: creates the handle in the graph under capture, launches
//   the kernel on `stream` (so the handle is set from the flag's value at
//   that point of the graph), adds the conditional node after it and makes
//   the node the stream's capture dependency; returns the handle and the
//   node's body graphs (1 for WHILE, 2 for IF: then, else);
// - uslam_capture_to / uslam_capture_end: capture a body from a second
//   stream (cudaStreamBeginCaptureToGraph);
// - uslam_cond_set: the kernel again, the last node of a WHILE body, which
//   sets the loop's handle for its next test;
// - uslam_graph_node_types: the type of every node of a captured body
//   (cudaGraphNodeType), so a check can show what a body holds (the
//   collectives' nodes among them).
//
// Its plain version is a host read of the same flag (the eager primitives of
// compiled.py). The kernel also counts what it decided into `counts`
// (int64[2]: value 1, value 0), so the host learns how often each body ran,
// and so how many launches of the other kernels those bodies hold, in a read
// it makes anyway.
//
// What bounds it: one byte in and one 8-byte word written, nanoseconds at
// the card's rates; its time is a launch's latency inside a graph. One
// thread does it all.

#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle, const bool* flag,
                                       long long* counts) {
  const unsigned int value = *flag ? 1u : 0u;
  if (counts != nullptr) counts[value ? 0 : 1] += 1;
  cudaGraphSetConditional(handle, value);
}

cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n_deps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, nullptr,
                                             n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, n_deps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                 : cudaErrorStreamCaptureImplicit;
}

}  // namespace

extern "C" int uslam_cond_set(void* stream, unsigned long long handle, const void* flag,
                              void* counts) {
  set_conditional_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      handle, static_cast<const bool*>(flag), static_cast<long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// type: 0 IF (two bodies: then, else), 1 WHILE (one body).
extern "C" int uslam_cond_node(void* stream_, int type, const void* flag, void* counts,
                               unsigned long long* handle_out, void** bodies_out) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(stream, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = uslam_cond_set(stream, handle, flag, counts);
  if (rc != 0) return rc;
  err = capture_info(stream, &graph, &deps, &n_deps);  // now: the kernel's node
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = type == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = type == 1 ? 1 : 2;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(stream, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  *handle_out = handle;
  for (unsigned int i = 0; i < params.conditional.size; ++i) {
    bodies_out[i] = params.conditional.phGraph_out[i];
  }
  return 0;
}

// A stream of its own for each depth of bodies: PyTorch's pool hands its
// streams out in turn, so one of them may be the stream a graph is being
// captured on.
extern "C" int uslam_stream_create(void** stream_out) {
  cudaStream_t stream;
  cudaError_t err = cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking);
  if (err == cudaSuccess) *stream_out = stream;
  return static_cast<int>(err);
}

extern "C" int uslam_capture_to(void* stream, void* graph) {
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(stream), static_cast<cudaGraph_t>(graph), nullptr, nullptr, 0,
      cudaStreamCaptureModeThreadLocal));
}

extern "C" int uslam_capture_end(void* stream) {
  cudaGraph_t graph;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &graph));
}

// The cudaGraphNodeType of each node of `graph` into `types` (at most
// `capacity`); `count` gets the number of nodes. A null `types` asks for the
// count alone. A node whose type cannot be read gets minus the error's code.
extern "C" int uslam_graph_node_types(void* graph_, int* types, int capacity, int* count) {
  cudaGraph_t graph = static_cast<cudaGraph_t>(graph_);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  *count = static_cast<int>(n);
  if (types == nullptr || n == 0) return 0;
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(graph, nodes.data(), &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (size_t i = 0; i < n && i < static_cast<size_t>(capacity); ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    types[i] = err == cudaSuccess ? static_cast<int>(type) : -static_cast<int>(err);
    if (err != cudaSuccess) cudaGetLastError();
  }
  return 0;
}
