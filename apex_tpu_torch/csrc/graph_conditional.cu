// Device-side control flow for the port's jit mode: CUDA graphs whose
// conditional nodes (IF, WHILE; CUDA 12.4+) take the place of the JAX
// package's lax.cond / lax.while_loop (apex_tpu/optim/lm.py _optimize_jit).
//
// optim/graphs.py records a jit program as a tree: plain CUDA graphs that
// PyTorch captured (torch.cuda.CUDAGraph(keep_graph=True), raw_cuda_graph),
// branches and loops. It builds one parent graph from that tree through the
// entry points below, walking it in order:
//   - a captured graph becomes a child-graph node (the graph is cloned into
//     the node; its memory stays in the PyTorch pool the capture used);
//   - a branch becomes a set-handle kernel node, then an IF node whose body
//     holds the branch's program. The kernel reads the branch's predicate,
//     a 0-d bool on the device, sets the node's handle from it and adds one
//     to the branch's taken count;
//   - a loop becomes an enter kernel node, then a WHILE node whose body holds
//     the loop's program followed by a next kernel node. The enter kernel
//     zeroes the loop's trip counter and sets the handle to
//     flag && max_trips > 0; the next kernel adds one to the trip counter
//     and to the loop's total, and sets the handle to
//     flag && trips < max_trips. The flag is the loop's 0-d bool, written by
//     the program before the loop and at the end of each trip.
// Every node of a graph depends on the node before it: the program's order.
// The counts (two int64 per conditional node: taken or total trips, and the
// running trip count) are what the host reads, once, after a solve: it
// cannot count branches or trips that the device decided.
//
// Conditional bodies accept kernel, memset, memcpy, empty, child-graph and
// conditional nodes, so a captured graph that holds anything else makes the
// build fail here, and the caller raises: there is no fallback.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (kernels/build.py). cudaGraph_t handles from PyTorch's
// CUDA runtime are the driver's graphs, so this library's own (static)
// runtime takes them as they are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle, const bool* pred,
                              long long* slots) {
  const bool take = *pred;
  cudaGraphSetConditional(handle, take ? 1u : 0u);
  if (take) slots[0] += 1;
}

__global__ void while_enter_kernel(cudaGraphConditionalHandle handle, const bool* flag,
                                   long long* slots, long long max_trips) {
  slots[1] = 0;
  cudaGraphSetConditional(handle, (*flag && max_trips > 0) ? 1u : 0u);
}

__global__ void while_next_kernel(cudaGraphConditionalHandle handle, const bool* flag,
                                  long long* slots, long long max_trips) {
  const long long trips = slots[1] + 1;
  slots[1] = trips;
  slots[0] += 1;
  cudaGraphSetConditional(handle, (*flag && trips < max_trips) ? 1u : 0u);
}

cudaError_t add_kernel(cudaGraphNode_t* node, cudaGraph_t graph, cudaGraphNode_t dep,
                       void* func, void** args) {
  cudaKernelNodeParams p = {};
  p.func = func;
  p.gridDim = dim3(1, 1, 1);
  p.blockDim = dim3(1, 1, 1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, dep ? &dep : nullptr, dep ? 1 : 0, &p);
}

cudaError_t add_conditional(cudaGraphNode_t* node, cudaGraph_t graph, cudaGraphNode_t dep,
                            cudaGraphConditionalHandle handle,
                            cudaGraphConditionalNodeType type, cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = type;
  p.conditional.size = 1;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaGraphAddNode(node, graph, &dep, nullptr, 1, &p);
#else
  cudaError_t err = cudaGraphAddNode(node, graph, &dep, 1, &p);
#endif
  if (err == cudaSuccess) *body = p.conditional.phGraph_out[0];
  return err;
}

// Adds the node census of `graph` to `counts`, recursing into child graphs:
// counts[t] for node type t (0-15), then kernel nodes launched cooperatively
// (16), in clusters of more than one CTA (17), with programmatic stream
// serialization (18), and memcpy nodes that are not device to device (19).
cudaError_t census(cudaGraph_t graph, long long* counts) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  err = cudaGraphGetNodes(graph, nodes, &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    if ((err = cudaGraphNodeGetType(nodes[i], &type)) != cudaSuccess) break;
    if ((int)type < 16) counts[(int)type] += 1;
    if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      if ((err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child)) == cudaSuccess)
        err = census(child, counts);
    } else if (type == cudaGraphNodeTypeKernel) {
      cudaLaunchAttributeValue v;
      if (cudaGraphKernelNodeGetAttribute(nodes[i], cudaLaunchAttributeCooperative, &v) ==
              cudaSuccess && v.cooperative)
        counts[16] += 1;
      if (cudaGraphKernelNodeGetAttribute(nodes[i], cudaLaunchAttributeClusterDimension, &v) ==
              cudaSuccess && v.clusterDim.x * v.clusterDim.y * v.clusterDim.z > 1)
        counts[17] += 1;
      if (cudaGraphKernelNodeGetAttribute(
              nodes[i], cudaLaunchAttributeProgrammaticStreamSerialization, &v) == cudaSuccess &&
          v.programmaticStreamSerializationAllowed)
        counts[18] += 1;
      cudaGetLastError();
    } else if (type == cudaGraphNodeTypeMemcpy) {
      cudaMemcpy3DParms m = {};
      if (cudaGraphMemcpyNodeGetParams(nodes[i], &m) == cudaSuccess &&
          m.kind != cudaMemcpyDeviceToDevice)
        counts[19] += 1;
      cudaGetLastError();
    }
  }
  delete[] nodes;
  return err;
}

}  // namespace

extern "C" {

// The census of `graph` (see census above) into counts[20], zeroed first:
// what a refused graph holds, for the caller's error.
int gc_graph_census(void* graph, long long* counts) {
  for (int i = 0; i < 20; ++i) counts[i] = 0;
  return (int)census((cudaGraph_t)graph, counts);
}


const char* gc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int gc_versions(int* runtime, int* driver) {
  cudaError_t err = cudaRuntimeGetVersion(runtime);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDriverGetVersion(driver);
}

// Makes `device` current for this library's runtime (it keeps its own
// current device) and returns the one that was: the build of a graph that
// holds kernel nodes runs with the device of its kernels current.
int gc_use_device(int device, int* prev) {
  cudaError_t err = cudaGetDevice(prev);
  if (err != cudaSuccess || *prev == device) return (int)err;
  return (int)cudaSetDevice(device);
}

int gc_graph_create(void** graph) {
  return (int)cudaGraphCreate(reinterpret_cast<cudaGraph_t*>(graph), 0);
}

int gc_graph_destroy(void* graph) { return (int)cudaGraphDestroy((cudaGraph_t)graph); }

int gc_graph_nodes(void* graph, unsigned long long* count) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &n);
  *count = n;
  return (int)err;
}

// A child-graph node of `child` (cloned) after `dep` (null: none).
int gc_add_child(void* graph, void* dep, void* child, void** node) {
  cudaGraphNode_t d = (cudaGraphNode_t)dep;
  return (int)cudaGraphAddChildGraphNode(reinterpret_cast<cudaGraphNode_t*>(node),
                                         (cudaGraph_t)graph, d ? &d : nullptr, d ? 1 : 0,
                                         (cudaGraph_t)child);
}

// The set-handle kernel and the IF node after `dep`; `body` is the IF
// node's (empty) body graph, `slots` the branch's two counters.
int gc_add_if(void* graph, void* dep, const void* pred, void* slots, void** node, void** body) {
  cudaGraphConditionalHandle handle;
  cudaError_t err = cudaGraphConditionalHandleCreate(&handle, (cudaGraph_t)graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNode_t set;
  void* args[] = {&handle, &pred, &slots};
  err = add_kernel(&set, (cudaGraph_t)graph, (cudaGraphNode_t)dep, (void*)set_if_kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)add_conditional(reinterpret_cast<cudaGraphNode_t*>(node), (cudaGraph_t)graph,
                              set, handle, cudaGraphCondTypeIf,
                              reinterpret_cast<cudaGraph_t*>(body));
}

// The enter kernel and the WHILE node after `dep`; `body` is the WHILE
// node's body graph and `handle` its handle, for gc_add_while_next.
int gc_add_while(void* graph, void* dep, const void* flag, void* slots, long long max_trips,
                 void** node, void** body, unsigned long long* handle) {
  cudaGraphConditionalHandle h;
  cudaError_t err = cudaGraphConditionalHandleCreate(&h, (cudaGraph_t)graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNode_t enter;
  void* args[] = {&h, &flag, &slots, &max_trips};
  err = add_kernel(&enter, (cudaGraph_t)graph, (cudaGraphNode_t)dep,
                   (void*)while_enter_kernel, args);
  if (err != cudaSuccess) return (int)err;
  *handle = h;
  return (int)add_conditional(reinterpret_cast<cudaGraphNode_t*>(node), (cudaGraph_t)graph,
                              enter, h, cudaGraphCondTypeWhile,
                              reinterpret_cast<cudaGraph_t*>(body));
}

// The next kernel at the end of a WHILE body, after `dep`.
int gc_add_while_next(void* body, void* dep, unsigned long long handle, const void* flag,
                      void* slots, long long max_trips, void** node) {
  cudaGraphConditionalHandle h = handle;
  void* args[] = {&h, &flag, &slots, &max_trips};
  return (int)add_kernel(reinterpret_cast<cudaGraphNode_t*>(node), (cudaGraph_t)body,
                         (cudaGraphNode_t)dep, (void*)while_next_kernel, args);
}

int gc_instantiate(void* graph, void** exec) {
  return (int)cudaGraphInstantiate(reinterpret_cast<cudaGraphExec_t*>(exec),
                                   (cudaGraph_t)graph, 0);
}

int gc_launch(void* exec, void* stream, int device) {
  int prev;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  err = cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

int gc_exec_destroy(void* exec) { return (int)cudaGraphExecDestroy((cudaGraphExec_t)exec); }

}  // extern "C"
