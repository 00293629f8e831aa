// The device operations captured so far into the CUDA graph that a stream
// is capturing: its kernel, memcpy and memset nodes, the kinds of graph
// node whose execution the profiler reports as a device operation (event,
// host, empty and child-graph nodes run none of their own here).
//
// spans.Census reads it when a span opens and closes during a capture
// (runtime/fused_step.py, CapturedFrame.run), so each stage of a captured
// part knows which of the graph's device operations are its own. It runs
// at capture only, in set-up, and launches no kernel: the only C entry of
// csrc/ that does not. The graph is read as the runtime allows while the
// capture is in progress (queries, no node removal).

#include <cuda_runtime.h>

#include <vector>

// *ops = the count. Returns a cudaError_t, or -1 when the stream is not
// capturing.
extern "C" int capture_ops(void* stream, long long* ops) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t err =
      cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, &id, &graph);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive || graph == nullptr) return -1;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return (int)err;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0) {
    err = cudaGraphGetNodes(graph, nodes.data(), &n);
    if (err != cudaSuccess) return (int)err;
  }
  long long count = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return (int)err;
    count += type == cudaGraphNodeTypeKernel ||
             type == cudaGraphNodeTypeMemcpy ||
             type == cudaGraphNodeTypeMemset;
  }
  *ops = count;
  return 0;
}
