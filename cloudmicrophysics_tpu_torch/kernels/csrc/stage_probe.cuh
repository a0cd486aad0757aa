// Stage timing of the warp-per-column kernels (column1m.cu, column2m.cu):
// with STAGE_PROBE defined before the include (each source defines it in
// its probe build: -DK1_PROBE, -DK3_PROBE), each warp sums the clock64()
// cycles of every stage of its passes (kept by lane 0) and adds them, with
// its pass count, to the buffer g_stage_probe points at (set by the
// source's <name>_probe_set) when it ends. A stage ends once its results
// are in registers: PROBE_SINK stores them to shared memory, a side effect
// the clock read is not moved across. The sinks add a few instructions, so
// the probe's times are near the kernel's, not equal. Without STAGE_PROBE
// the stamps compile to nothing.

#ifndef CMT_STAGE_PROBE_CUH
#define CMT_STAGE_PROBE_CUH

enum ProbeStage { S_LOAD, S_CELL, S_EXCHANGE, S_STORE, S_COUNT };

#ifdef STAGE_PROBE
__device__ unsigned long long* g_stage_probe;
struct Probe {
  long long sum[S_COUNT], last, passes;
  __device__ void start() {
    for (int s = 0; s < S_COUNT; ++s) sum[s] = 0;
    passes = 0;
    last = clock64();
  }
  __device__ void stage(int s) {
    const long long now = clock64();
    sum[s] += now - last;
    last = now;
  }
  __device__ void flush() {
    if ((threadIdx.x & 31) != 0) return;
    for (int s = 0; s < S_COUNT; ++s)
      atomicAdd(g_stage_probe + s, (unsigned long long)sum[s]);
    atomicAdd(g_stage_probe + S_COUNT, (unsigned long long)passes);
  }
};
__shared__ volatile float stage_sink[1024];
#define PROBE_START \
  Probe probe;      \
  probe.start()
#define PROBE_SINK(v) (stage_sink[threadIdx.x] = (v))
#define PROBE_STAGE(s) probe.stage(s)
#define PROBE_PASS (++probe.passes)
#define PROBE_END probe.flush()
#else
#define PROBE_START
#define PROBE_SINK(v)
#define PROBE_STAGE(s)
#define PROBE_PASS
#define PROBE_END
#endif

#endif  // CMT_STAGE_PROBE_CUH
