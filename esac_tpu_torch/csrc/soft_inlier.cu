// Soft-inlier scoring and fused score+select for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of esac_tpu/ransac/pallas_scoring.py:
//   esac_soft_inlier_scores  <- _score_kernel (pallas_scoring.py:94-109,
//                               launched by _scores_pallas_raw :150-192)
//   esac_soft_inlier_select  <- _score_select_kernel (:301-357, launched
//                               by _select_pallas_raw :360-413)
// Both share the tile math of _tile_partial_scores (:55-91): for pose
// (R | t) and cell (X, pixel): Y = R X + t; z = max(Y_z, 0.1);
// err = sqrt(du^2 + dv^2 + 1e-12) with du = f Y_x / z + cx - px (and dv
// likewise), +1000 px where Y_z < 0.1; score = sum over cells of
// 1 / (1 + exp(-beta (tau - err))).  No (H, N) map reaches memory.
//
// What bounds it on this card: operations, not bytes.  Per (hypothesis,
// cell) pair the formula costs ~30 FP32 operations, of which two
// divisions, one sqrt, one exp and one reciprocal go through the special
// function units (4 per SM sub-partition), so the SFU is the tighter
// limit; the inputs are 48 B per hypothesis and 20 B per cell, read from
// L2 once per hypothesis group.  The design therefore spends nothing on
// data movement beyond one pass per block: each block holds 8 hypotheses'
// poses in shared memory (broadcast reads), its 256 threads stride over the
// cells keeping 8 partial sums in registers, and a fixed-order warp/block
// reduction finishes -- deterministic from run to run.  The K = 3
// contraction is broadcast FMAs (no tensor cores).  Built without
// --use_fast_math: IEEE division, sqrtf and expf keep the kernel within
// summation-order distance of the plain PyTorch version.
//
// GPU blocks run in no order, so the TPU kernel's sequential revisiting of
// one output block has no counterpart: one block owns one (problem,
// hypothesis group) and sweeps all cells itself; no float atomics.  The
// select keeps jnp.argmax's first-max contract without relying on block
// order: each block writes (its max, the smallest index attaining it),
// and a second pass folds those partials per problem in index order,
// replacing only on a strictly greater score, then copies the winner's
// 12-float pose row bit-exactly.
//
// One launch covers all P = B * M (frame, expert) problems of a dispatch:
// poses (P, H, 12) [R row-major | t], coords (P, N, 3), pixels (G, N, 2)
// with problem p reading pixel group p / (P / G), focal f (P,), principal
// point c (2,).  Ragged H and N are masked in the kernel; nothing is padded.
// Every exported function returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHyps = 8;  // hypotheses per block
constexpr float kMinDepth = 0.1f;

struct Tile {
  float pose[kHyps * 12];
  float red[kWarps * kHyps];
  float score[kHyps];
};

// Scores of hypotheses [h0, h0 + n_valid) of one problem (n_valid <= kHyps)
// into t.score[0 .. kHyps); rows past n_valid read zero poses and are
// ignored by the callers.
__device__ void block_scores(const float* __restrict__ poses,
                             const float* __restrict__ coords,
                             const float* __restrict__ pixels,
                             float f, float cx, float cy, int N, int n_valid,
                             float tau, float beta, Tile& t) {
  const int tid = threadIdx.x;
  for (int i = tid; i < kHyps * 12; i += kThreads)
    t.pose[i] = (i / 12 < n_valid) ? poses[i] : 0.0f;
  __syncthreads();

  float acc[kHyps];
#pragma unroll
  for (int k = 0; k < kHyps; ++k) acc[k] = 0.0f;

  for (int n = tid; n < N; n += kThreads) {
    const float X0 = coords[3 * n], X1 = coords[3 * n + 1], X2 = coords[3 * n + 2];
    const float px = pixels[2 * n], py = pixels[2 * n + 1];
#pragma unroll
    for (int k = 0; k < kHyps; ++k) {
      const float* q = t.pose + 12 * k;
      const float Yx = q[0] * X0 + q[1] * X1 + q[2] * X2 + q[9];
      const float Yy = q[3] * X0 + q[4] * X1 + q[5] * X2 + q[10];
      const float Yz = q[6] * X0 + q[7] * X1 + q[8] * X2 + q[11];
      const float z = fmaxf(Yz, kMinDepth);
      const float du = f * Yx / z + cx - px;
      const float dv = f * Yy / z + cy - py;
      float err = sqrtf(du * du + dv * dv + 1e-12f);
      if (Yz < kMinDepth) err += 1000.0f;
      acc[k] += 1.0f / (1.0f + expf(-(beta * (tau - err))));
    }
  }

  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < kHyps; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) t.red[warp * kHyps + k] = v;
  }
  __syncthreads();
  if (tid < kHyps) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += t.red[w * kHyps + tid];
    t.score[tid] = s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
score_kernel(const float* __restrict__ poses, const float* __restrict__ coords,
             const float* __restrict__ pixels, const float* __restrict__ f,
             const float* __restrict__ c, int P, int H, int N, int G,
             float tau, float beta, float* __restrict__ out) {
  __shared__ Tile t;
  const int p = blockIdx.y, h0 = blockIdx.x * kHyps;
  const int n_valid = min(kHyps, H - h0);
  const int g = p / (P / G);
  block_scores(poses + ((size_t)p * H + h0) * 12, coords + (size_t)p * N * 3,
               pixels + (size_t)g * N * 2, f[p], c[0], c[1], N, n_valid,
               tau, beta, t);
  if (threadIdx.x < n_valid) out[(size_t)p * H + h0 + threadIdx.x] = t.score[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
select_partial_kernel(const float* __restrict__ poses, const float* __restrict__ coords,
                      const float* __restrict__ pixels, const float* __restrict__ f,
                      const float* __restrict__ c, int P, int H, int N, int G,
                      float tau, float beta, float* __restrict__ part_score,
                      int* __restrict__ part_idx) {
  __shared__ Tile t;
  const int p = blockIdx.y, h0 = blockIdx.x * kHyps;
  const int n_valid = min(kHyps, H - h0);
  const int g = p / (P / G);
  block_scores(poses + ((size_t)p * H + h0) * 12, coords + (size_t)p * N * 3,
               pixels + (size_t)g * N * 2, f[p], c[0], c[1], N, n_valid,
               tau, beta, t);
  if (threadIdx.x == 0) {
    // First max inside the block: only a strictly greater score displaces.
    float best = -INFINITY;
    int bi = h0;
    for (int k = 0; k < n_valid; ++k)
      if (t.score[k] > best) { best = t.score[k]; bi = h0 + k; }
    part_score[(size_t)p * gridDim.x + blockIdx.x] = best;
    part_idx[(size_t)p * gridDim.x + blockIdx.x] = bi;
  }
}

__global__ void select_final_kernel(const float* __restrict__ poses,
                                    const float* __restrict__ part_score,
                                    const int* __restrict__ part_idx, int H, int n_blocks,
                                    int* __restrict__ best_idx, float* __restrict__ best_score,
                                    float* __restrict__ best_pose) {
  __shared__ int s_best;
  const int p = blockIdx.x;
  if (threadIdx.x == 0) {
    // Blocks in hypothesis order, strictly greater only: the first max wins.
    float best = -INFINITY;
    int bi = 0;
    for (int b = 0; b < n_blocks; ++b) {
      const float s = part_score[(size_t)p * n_blocks + b];
      if (s > best) { best = s; bi = part_idx[(size_t)p * n_blocks + b]; }
    }
    best_score[p] = best;
    best_idx[p] = bi;
    s_best = bi;
  }
  __syncthreads();
  if (threadIdx.x < 12)
    best_pose[(size_t)p * 12 + threadIdx.x] = poses[((size_t)p * H + s_best) * 12 + threadIdx.x];
}

}  // namespace

extern "C" {

int esac_hyps_per_block() { return kHyps; }

int esac_soft_inlier_scores(const float* poses, const float* coords, const float* pixels,
                            const float* f, const float* c, int P, int H, int N, int G,
                            float tau, float beta, float* out, void* stream) {
  const dim3 grid((H + kHyps - 1) / kHyps, P);
  score_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      poses, coords, pixels, f, c, P, H, N, G, tau, beta, out);
  return static_cast<int>(cudaGetLastError());
}

int esac_soft_inlier_select(const float* poses, const float* coords, const float* pixels,
                            const float* f, const float* c, int P, int H, int N, int G,
                            float tau, float beta, float* part_score, int* part_idx,
                            int* best_idx, float* best_score, float* best_pose,
                            void* stream) {
  const int n_blocks = (H + kHyps - 1) / kHyps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  select_partial_kernel<<<dim3(n_blocks, P), kThreads, 0, s>>>(
      poses, coords, pixels, f, c, P, H, N, G, tau, beta, part_score, part_idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  select_final_kernel<<<P, 32, 0, s>>>(poses, part_score, part_idx, H, n_blocks,
                                       best_idx, best_score, best_pose);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
