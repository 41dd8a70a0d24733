// dmt_trace_mark: a kernel of one thread that does nothing, launched as a
// mark on the device's timeline (utils/runtime.py ``mark``).
//
// Replaces no TPU kernel. A CUDA graph replays its kernels with no Python
// and no host range around them, so a profiler cannot tell which module of
// the captured step launched which of them. A mark launched at capture
// stays in the graph, and each replay runs it where the capture placed it:
// the profiler then records a ``dmt_trace_mark`` kernel between the work
// before it and the work after it, on the device's own clock. The n-th mark
// of a replay is the n-th entry of the capture's mark table
// (train/scan.py ``MultiStep.marks``): one stream, one order.
//
// What bounds it: the launch (a graph node's own cost, about a microsecond).
// It reads and writes nothing. Its name holds no substring of the kernel
// categories the benchmark sorts by, so it counts as "other" there.

#include <cuda_runtime.h>

extern "C" __global__ void dmt_trace_mark() {}

extern "C" int dmt_trace_mark_launch(void* stream) {
  dmt_trace_mark<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
