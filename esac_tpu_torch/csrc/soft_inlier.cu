// Soft-inlier scoring and fused score+select for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of esac_tpu/ransac/pallas_scoring.py:
//   esac_soft_inlier_scores  <- _score_kernel (pallas_scoring.py:94-109,
//                               launched by _scores_pallas_raw :150-192)
//   esac_soft_inlier_select  <- _score_select_kernel (:301-357, launched
//                               by _select_pallas_raw :360-413)
// Both compute the tile math of _tile_partial_scores (:55-91): for pose
// (R | t) and cell (X, pixel): Y = R X + t; z = max(Y_z, 0.1);
// err = sqrt(du^2 + dv^2 + 1e-12) with du = f Y_x / z + cx - px (and dv
// likewise), +1000 px where Y_z < 0.1; score = sum over cells of
// 1 / (1 + exp(-beta (tau - err))).  No (H, N) map reaches memory.
//
// What bounds it on this card: operations, not bytes.  The inputs are 48 B
// per hypothesis and 20 B per cell (2 MB at 28 problems x 256 hypotheses x
// 4800 cells) against ~40 FP32 operations per (hypothesis, cell) pair, of
// which the sqrt, exp and reciprocals are multi-instruction IEEE sequences
// around the special function units.  So what matters is issuing
// instructions on every SM sub-partition, with enough warps in flight to
// hide the dependent chain of each pair.
//
// Both entries run the same partial pass, then a final pass of their own:
// - Partial pass (partial_kernel): one thread per hypothesis.  A block owns
//   one problem, a tile of kTile hypotheses and one chunk of the cells; the
//   wrapper picks the number of chunks S so that the grid of
//   P x tiles x S blocks fills the card for about four waves of resident
//   blocks, so SMs that finish early take more work.  Each thread keeps its
//   12 pose floats, f, c and one accumulator in registers -- within the
//   48 registers that __launch_bounds__(kTile, 10) asks for, so 10 blocks
//   (40 warps) stay resident per SM.  The block stages its cells through
//   shared memory with coalesced loads; every thread of a warp then reads
//   the same cell (a broadcast, no bank conflicts).  Each thread writes its
//   partial sum to scratch (P, S, H).  One reciprocal of z per pair
//   (__frcp_rn, IEEE round-to-nearest) replaces the two divisions by z;
//   sqrtf, expf and 1 / (1 + e) stay IEEE (no --use_fast_math).
// - Score final pass (sum_kernel): one thread per hypothesis, a grid of
//   P x ceil(H / kSumThreads) blocks; loads coalesce along h.
// - Select final pass (select_final_kernel): one block per problem.  Each
//   thread keeps the first max of its hypotheses' scores, and a fixed-shape
//   tree over (score, index) pairs keeps the greater score and, on equal
//   scores, the smaller index -- jnp.argmax's first-max contract without
//   relying on block order.  It then copies the winner's 12-float pose row
//   bit-exactly.
// Both final passes sum a hypothesis' partials with the one helper
// hypothesis_score, in the order s = 0..S-1 from 0.0f.  So for one set of
// operands and one split, the score entry's scores at the select entry's
// winner are bit-equal to its best score.  No atomics: results are
// identical run to run.
//
// One launch of either entry covers all P = B * M (frame, expert) problems
// of a dispatch: poses (P, H, 12) [R row-major | t], coords (P, N, 3),
// pixels (G, N, 2) with problem p reading pixel group p / (P / G), focal
// f (P,), principal point c (2,).  Ragged H and N are masked in the kernel;
// nothing is padded.  Every exported function returns cudaGetLastError()
// after each of its launches.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>

namespace {

constexpr float kMinDepth = 0.1f;
constexpr int kTile = 128;  // hypotheses per partial-pass block, one per thread
#ifndef PARTIAL_BLOCKS_PER_SM  // -D override: esac_tpu_torch/tools/kernel_bound.py sweeps it
#define PARTIAL_BLOCKS_PER_SM 10
#endif
constexpr int kBlocksPerSM = PARTIAL_BLOCKS_PER_SM;  // 10 asks ptxas for <= 48 registers
constexpr int kStage = 256;  // cells staged in shared memory at a time
constexpr int kSumThreads = 128;
constexpr int kFinalThreads = 256;

// A staged cell: X and the pixel, 32 B so that both loads share one
// address register.
struct alignas(16) Cell {
  float4 a;  // X0, X1, X2, px
  float py, pad[3];
};

// One (hypothesis, cell) term of the score; q is [R row-major | t].
__device__ __forceinline__ float pair_score(const float (&q)[12], float X0, float X1,
                                            float X2, float px, float py, float f,
                                            float cx, float cy, float tau, float beta) {
  const float Yx = q[0] * X0 + q[1] * X1 + q[2] * X2 + q[9];
  const float Yy = q[3] * X0 + q[4] * X1 + q[5] * X2 + q[10];
  const float Yz = q[6] * X0 + q[7] * X1 + q[8] * X2 + q[11];
  const float inv_z = __frcp_rn(fmaxf(Yz, kMinDepth));
  const float du = f * Yx * inv_z + cx - px;
  const float dv = f * Yy * inv_z + cy - py;
  float err = sqrtf(du * du + dv * dv + 1e-12f);
  if (Yz < kMinDepth) err += 1000.0f;
  return 1.0f / (1.0f + expf(-(beta * (tau - err))));
}

// blockIdx.x = chunk * n_tiles + tile, blockIdx.y = problem.  Cells
// [chunk * cells, min(N, (chunk + 1) * cells)) of hypotheses
// [tile * kTile, ...) into part[p][chunk][h].
__global__ void __launch_bounds__(kTile, kBlocksPerSM)
partial_kernel(const float* __restrict__ poses, const float* __restrict__ coords,
               const float* __restrict__ pixels, const float* __restrict__ f,
               const float* __restrict__ c, int P, int H, int N, int G, int cells,
               float tau, float beta, float* __restrict__ part) {
  __shared__ Cell s_cell[kStage];
  const int n_tiles = (H + kTile - 1) / kTile;
  const int tile = blockIdx.x % n_tiles, chunk = blockIdx.x / n_tiles;
  const int n_chunks = gridDim.x / n_tiles;
  const int p = blockIdx.y, g = p / (P / G);
  const int h = tile * kTile + threadIdx.x;
  const bool active = h < H;

  float q[12];
  const float4* row = reinterpret_cast<const float4*>(poses + ((size_t)p * H + (active ? h : 0)) * 12);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 v = row[k];
    q[4 * k] = v.x; q[4 * k + 1] = v.y; q[4 * k + 2] = v.z; q[4 * k + 3] = v.w;
  }
  const float fp = f[p], cx = c[0], cy = c[1];
  const float* X = coords + (size_t)p * N * 3;
  const float* pix = pixels + (size_t)g * N * 2;
  const int n0 = chunk * cells, n1 = min(N, n0 + cells);

  float acc = 0.0f;
  for (int base = n0; base < n1; base += kStage) {
    const int cnt = min(kStage, n1 - base);
    __syncthreads();  // the previous stage is consumed
    for (int i = threadIdx.x; i < cnt; i += kTile) {
      const int n = base + i;
      s_cell[i].a = make_float4(X[3 * n], X[3 * n + 1], X[3 * n + 2], pix[2 * n]);
      s_cell[i].py = pix[2 * n + 1];
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int k = 0; k < cnt; ++k) {
        const float4 a = s_cell[k].a;
        acc += pair_score(q, a.x, a.y, a.z, a.w, s_cell[k].py, fp, cx, cy, tau, beta);
      }
    }
  }
  if (active) part[((size_t)p * n_chunks + chunk) * H + h] = acc;
}

// The score of hypothesis h: its partials pp[s * H + h] summed in the order
// s = 0..S-1 from 0.0f.  The one expression both final passes use.
__device__ __forceinline__ float hypothesis_score(const float* __restrict__ pp, int H,
                                                  int n_chunks, int h) {
  float score = 0.0f;
#pragma unroll 16  // loads in flight; the sum still runs s = 0, 1, ...
  for (int s = 0; s < n_chunks; ++s) score += pp[(size_t)s * H + h];
  return score;
}

// blockIdx.x = hypothesis block, blockIdx.y = problem.
__global__ void __launch_bounds__(kSumThreads)
sum_kernel(const float* __restrict__ part, int H, int n_chunks, float* __restrict__ out) {
  const int p = blockIdx.y, h = blockIdx.x * kSumThreads + threadIdx.x;
  if (h < H) out[(size_t)p * H + h] = hypothesis_score(part + (size_t)p * n_chunks * H, H,
                                                       n_chunks, h);
}

// (s, i) <- (os, oi) if os is greater, or equal with a smaller index.
__device__ __forceinline__ void keep_first_max(float& s, int& i, float os, int oi) {
  if (os > s || (os == s && oi < i)) { s = os; i = oi; }
}

__device__ __forceinline__ void warp_first_max(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, s, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    keep_first_max(s, i, os, oi);
  }
}

__global__ void __launch_bounds__(kFinalThreads)
select_final_kernel(const float* __restrict__ poses, const float* __restrict__ part, int H,
                    int n_chunks, int* __restrict__ best_idx, float* __restrict__ best_score,
                    float* __restrict__ best_pose) {
  constexpr int kFinalWarps = kFinalThreads / 32;
  __shared__ float w_score[kFinalWarps];
  __shared__ int w_idx[kFinalWarps];
  __shared__ int s_best;
  const int p = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* pp = part + (size_t)p * n_chunks * H;

  // Hypotheses in increasing order, strictly greater only: the thread's
  // first max.  A NaN score never wins.
  float best = -INFINITY;
  int bi = INT_MAX;
  for (int h = tid; h < H; h += kFinalThreads) {
    const float score = hypothesis_score(pp, H, n_chunks, h);
    if (score > best) { best = score; bi = h; }
  }
  warp_first_max(best, bi);
  if (lane == 0) { w_score[warp] = best; w_idx[warp] = bi; }
  __syncthreads();
  if (warp == 0) {
    best = lane < kFinalWarps ? w_score[lane] : -INFINITY;
    bi = lane < kFinalWarps ? w_idx[lane] : INT_MAX;
    warp_first_max(best, bi);
    if (lane == 0) {
      if (bi >= H) bi = 0;  // every score NaN
      best_score[p] = best;
      best_idx[p] = bi;
      s_best = bi;
    }
  }
  __syncthreads();
  if (tid < 12)
    best_pose[(size_t)p * 12 + tid] = poses[((size_t)p * H + s_best) * 12 + tid];
}

cudaError_t launch_partial(const float* poses, const float* coords, const float* pixels,
                           const float* f, const float* c, int P, int H, int N, int G,
                           int n_chunks, int cells, float tau, float beta, float* part,
                           cudaStream_t stream) {
  const int n_tiles = (H + kTile - 1) / kTile;
  partial_kernel<<<dim3(n_tiles * n_chunks, P), kTile, 0, stream>>>(
      poses, coords, pixels, f, c, P, H, N, G, cells, tau, beta, part);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of the partial pass resident on one SM.
int esac_partial_blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, partial_kernel, kTile, 0) !=
      cudaSuccess)
    return 0;
  return n;
}

int esac_partial_tile() { return kTile; }

int esac_soft_inlier_scores(const float* poses, const float* coords, const float* pixels,
                            const float* f, const float* c, int P, int H, int N, int G,
                            int n_chunks, int cells, float tau, float beta, float* part,
                            float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_partial(poses, coords, pixels, f, c, P, H, N, G, n_chunks,
                                         cells, tau, beta, part, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_kernel<<<dim3((H + kSumThreads - 1) / kSumThreads, P), kSumThreads, 0, s>>>(
      part, H, n_chunks, out);
  return static_cast<int>(cudaGetLastError());
}

int esac_soft_inlier_select(const float* poses, const float* coords, const float* pixels,
                            const float* f, const float* c, int P, int H, int N, int G,
                            int n_chunks, int cells, float tau, float beta, float* part,
                            int* best_idx, float* best_score, float* best_pose, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = launch_partial(poses, coords, pixels, f, c, P, H, N, G, n_chunks,
                                         cells, tau, beta, part, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  select_final_kernel<<<P, kFinalThreads, 0, s>>>(poses, part, H, n_chunks, best_idx,
                                                  best_score, best_pose);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
