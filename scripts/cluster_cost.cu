// What a thread-block cluster costs on this card at K3's explorer shape
// (32 particles x 4 scene tiles = 128 blocks of 256 threads): the same
// kernel body (a short FP32 loop, then a 30-term block sum) launched
//   plain    - no cluster; every block writes its own sums;
//   cluster  - as clusters of 4 blocks, no cluster barrier;
//   reduce   - as clusters of 4, rank 0 adding the other ranks' sums
//              through distributed shared memory between two
//              cluster.sync() calls, as a cluster reduce of K3 would.
// Device us per launch: 20 launches in one CUDA graph, timed with events.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o cluster_cost scripts/cluster_cost.cu
//   ./cluster_cost
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdio.h>

namespace cg = cooperative_groups;

template <int kMode>
__global__ void body(float* out, int iters) {
  __shared__ float sums[30];
  float v = threadIdx.x;
  for (int i = 0; i < iters; ++i) v = __fmaf_rn(v, 0.999f, 0.5f);
  if (threadIdx.x < 30) sums[threadIdx.x] = v;
  __syncthreads();
  float acc = threadIdx.x < 30 ? sums[threadIdx.x] : 0.0f;
  if (kMode == 2) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (cluster.block_rank() == 0 && threadIdx.x < 30) {
      for (int o = 1; o < (int)cluster.num_blocks(); ++o) {
        acc += cluster.map_shared_rank(sums, o)[threadIdx.x];
      }
    }
    cluster.sync();
  }
  if (threadIdx.x < 30) out[blockIdx.x * 30 + threadIdx.x] = acc;
}

template <int kMode>
float time_us(float* out, int iters) {
  cudaStream_t s;
  cudaStreamCreate(&s);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(128);
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 4;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kMode == 0 ? 0 : 1;
  cudaGraph_t g;
  cudaGraphExec_t ge;
  cudaStreamBeginCapture(s, cudaStreamCaptureModeGlobal);
  for (int i = 0; i < 20; ++i) cudaLaunchKernelEx(&cfg, body<kMode>, out, iters);
  cudaStreamEndCapture(s, &g);
  cudaGraphInstantiate(&ge, g, 0);
  cudaGraphLaunch(ge, s);
  cudaStreamSynchronize(s);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0, s);
  cudaGraphLaunch(ge, s);
  cudaEventRecord(e1, s);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms / 20 * 1000;
}

int main() {
  float* out;
  cudaMalloc(&out, 128 * 30 * sizeof(float));
  for (int iters : {0, 1024, 4096}) {
    for (int rep = 0; rep < 2; ++rep) {
      printf("loop %4d: plain %.2f us, cluster %.2f us, reduce %.2f us\n", iters,
             time_us<0>(out, iters), time_us<1>(out, iters), time_us<2>(out, iters));
    }
  }
  const cudaError_t err = cudaGetLastError();
  printf("%s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
