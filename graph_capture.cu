// Capture of a stream into a CUDA graph, with what the graph holds: the
// check that a kernel pair launched as a programmatic dependent keeps its
// programmatic edge inside a graph (chip_smoke.py phase 3,
// att_stream_bench.py).  Not part of the package: built by graph_capture.py.
#include <cuda_runtime.h>

#define GC_EXPORT extern "C" __attribute__((visibility("default")))

// Start capturing `stream` into a CUDA graph (relaxed mode), for
// graph_capture_end.
GC_EXPORT int graph_capture_begin(void* stream) {
  return (int)cudaStreamBeginCapture(static_cast<cudaStream_t>(stream),
                                     cudaStreamCaptureModeRelaxed);
}

// End the capture begun by graph_capture_begin, write what the graph holds
// into counts[3] -- its nodes, its edges and, of them, the programmatic
// ones (-1 where this CUDA cannot tell an edge's type) -- then launch it
// once on `stream` and free it.
GC_EXPORT int graph_capture_end(void* stream, int* counts) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph = nullptr;
  cudaError_t e = cudaStreamEndCapture(s, &graph);
  if (e != cudaSuccess) return (int)e;
  size_t nodes = 0, edges = 0;
  int programmatic = -1;
  e = cudaGraphGetNodes(graph, nullptr, &nodes);
#if CUDART_VERSION >= 12030
  if (e == cudaSuccess) {
#if CUDART_VERSION >= 13000
    e = cudaGraphGetEdges(graph, nullptr, nullptr, nullptr, &edges);
#else
    e = cudaGraphGetEdges_v2(graph, nullptr, nullptr, nullptr, &edges);
#endif
  }
  if (e == cudaSuccess && edges > 0) {
    cudaGraphNode_t from[64], to[64];
    cudaGraphEdgeData data[64];
    size_t n = edges < 64 ? edges : 64;
#if CUDART_VERSION >= 13000
    e = cudaGraphGetEdges(graph, from, to, data, &n);
#else
    e = cudaGraphGetEdges_v2(graph, from, to, data, &n);
#endif
    programmatic = 0;
    for (size_t i = 0; e == cudaSuccess && i < n; ++i)
      programmatic += data[i].type == cudaGraphDependencyTypeProgrammatic;
  }
#else
  if (e == cudaSuccess) e = cudaGraphGetEdges(graph, nullptr, nullptr, &edges);
#endif
  cudaGraphExec_t exec = nullptr;
  if (e == cudaSuccess) e = cudaGraphInstantiate(&exec, graph, 0);
  if (e == cudaSuccess) e = cudaGraphLaunch(exec, s);
  if (exec != nullptr) cudaGraphExecDestroy(exec);
  cudaGraphDestroy(graph);
  counts[0] = (int)nodes;
  counts[1] = (int)edges;
  counts[2] = programmatic;
  return (int)e;
}

GC_EXPORT const char* graph_capture_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
