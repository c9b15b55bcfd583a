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
// by the kernel below, so a graph that loops or branches never waits on the
// host.
//
// What the kernel sets a handle from (`Cond`, laid out as
// compiled.py's `_CondArgs`): either a 0-d bool (an IF node's predicate),
// or a loop's test, which the kernel computes itself from the loop's own
// 0-d tensors: `counter < limit` (int64; `limit` fixed in the graph), and
// `value > threshold` where given (float32 or float64, NaN > x false, as
// torch compares), and `!stop` where given (bool). The LM's test is
// `iterations < max_iterations` and not converged, the CG's `it < iters` and
// `rr > thresh` (compiled.py `Test`). So a WHILE test is one kernel node,
// where computing the flag first in torch took three more (the two
// comparisons and their `&`).
//
// The host half (uslam_tpu_torch/solvers/compiled.py) calls, while a graph is
// being captured on `stream`:
// - uslam_cond_node: creates the handle in the graph under capture, launches
//   the kernel on `stream` (so the handle is set from the operands' values
//   at that point of the graph), adds the conditional node after it and
//   makes the node the stream's capture dependency; returns the handle and
//   the node's body graphs (1 for WHILE, 2 for IF: then, else);
// - uslam_capture_to / uslam_capture_end: capture a body from a second
//   stream (cudaStreamBeginCaptureToGraph);
// - uslam_cond_set: the kernel again, the last node of a WHILE body, which
//   sets the loop's handle for its next test;
// - uslam_graph_node_types: the type of every node of a captured body
//   (cudaGraphNodeType), so a check can show what a body holds (the
//   collectives' nodes among them);
// - uslam_empty_kernel: a kernel that does nothing, a measuring stick: the
//   time of one kernel node in a graph, the floor of any one-thread node.
//
// Its plain version is a host read of the same flag (the eager primitives of
// compiled.py; a test's flag computed in torch, `Test.flag`). The kernel
// also counts what it decided into `counts` (int64[2]: value 1, value 0), so
// the host learns how often each body ran, and so how many launches of the
// other kernels those bodies hold, in a read it makes anyway.
//
// What bounds it: a few bytes in (at most an 8-byte counter, two 8-byte
// values and a bool) and one 8-byte count read and written, nanoseconds at
// the card's rates; its time is a kernel node's latency inside a graph. One
// thread does it all.

#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

namespace {

// A conditional handle's operands; the host's ctypes mirror is
// compiled.py's `_CondArgs` (same order, natural alignment).
struct Cond {
  const bool* flag;           // non-null: the handle is this bool; the rest is unused
  const long long* counter;   // int64
  long long limit;
  const void* value;          // null, or float32 / float64 as value_type says
  const void* threshold;      // the same type as value
  const bool* stop;           // null, or a bool that ends the loop when true
  int value_type;             // 0 float32, 1 float64
};

// Every operand and both counts are read before any is used, so the loads
// overlap: one memory latency, where reading the next operand only after
// the last comparison (or the count after the decision) would chain two or
// three.
__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle, Cond c,
                                       long long* counts) {
  long long n_true = 0, n_false = 0, counter = 0;
  if (counts != nullptr) {
    n_true = counts[0];
    n_false = counts[1];
  }
  bool flag = false, stop = false, above = true;
  if (c.flag != nullptr) flag = *c.flag;
  if (c.counter != nullptr) counter = *c.counter;
  if (c.value != nullptr) {
    if (c.value_type == 1) {
      above = *static_cast<const double*>(c.value) > *static_cast<const double*>(c.threshold);
    } else {
      above = *static_cast<const float*>(c.value) > *static_cast<const float*>(c.threshold);
    }
  }
  if (c.stop != nullptr) stop = *c.stop;
  const bool go = c.flag != nullptr ? flag : (counter < c.limit) & above & !stop;
  if (counts != nullptr) {
    if (go) {
      counts[0] = n_true + 1;
    } else {
      counts[1] = n_false + 1;
    }
  }
  cudaGraphSetConditional(handle, go ? 1u : 0u);
}

__global__ void empty_kernel() {}

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

extern "C" int uslam_cond_set(void* stream, unsigned long long handle, const void* cond,
                              void* counts) {
  set_conditional_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      handle, *static_cast<const Cond*>(cond), static_cast<long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int uslam_empty_kernel(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// type: 0 IF (two bodies: then, else), 1 WHILE (one body). cond: a Cond.
extern "C" int uslam_cond_node(void* stream_, int type, const void* cond, void* counts,
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
  int rc = uslam_cond_set(stream, handle, cond, counts);
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
