// The nodes of the CUDA graph a stream is capturing into: the count that
// utils/profiling.py's capture maps mark span boundaries with.  Host code
// only; no kernel.

#include <cuda_runtime.h>

#include <vector>

extern "C" {

// Nodes of the graph that ``stream`` is capturing into: all of them, or
// with ``device_only`` its kernel, memcpy and memset nodes (a walk over
// every node); -1 where the stream is not capturing, -2 where a query
// fails.  A single-stream capture is a chain, so device node i is the
// i-th device event of each replay.
long long srt_capture_nodes(void* stream, int device_only) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                               &id, &graph) != cudaSuccess)
    return -2;
  if (status != cudaStreamCaptureStatusActive || graph == nullptr) return -1;
  size_t n = 0;
  if (cudaGraphGetNodes(graph, nullptr, &n) != cudaSuccess) return -2;
  if (!device_only) return static_cast<long long>(n);
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0 && cudaGraphGetNodes(graph, nodes.data(), &n) != cudaSuccess)
    return -2;
  long long device = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    if (cudaGraphNodeGetType(nodes[i], &type) != cudaSuccess) return -2;
    if (type == cudaGraphNodeTypeKernel || type == cudaGraphNodeTypeMemcpy ||
        type == cudaGraphNodeTypeMemset)
      ++device;
  }
  return device;
}

}  // extern "C"
