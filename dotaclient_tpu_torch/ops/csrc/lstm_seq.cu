// Whole-sequence LSTM forward for Hopper (sm_90a), one thread-block cluster
// per tile of batch rows.
//
// Replaces the Pallas TPU kernel `_kernel` launched by `_pallas_forward` in
// dotaclient_tpu/ops/pallas/lstm.py. Same function, same contract: for each
// step t of a batch-major sequence,
//
//     (h, c) *= (1 - reset_t)                      reset BEFORE the step
//     gates   = x_t @ Wx + h @ Wh + b              f32 accumulation, i,f,g,o
//     c'      = sigmoid(f) * c + sigmoid(i) * tanh(g)
//     h'      = sigmoid(o) * tanh(c')
//
// writing hs[:, t] every step and (hT, cT) at the end. Everything is f32.
//
// What bounds it on an H100. At the serving shape (B=64, T=1, D=H=128) the
// work is 16.8 MFLOP against ~0.7 MB of compulsory traffic: under 0.3 us at
// the card's peaks, so the real limits are latencies: the launch, getting
// the 512 KB of f32 weights (Wx and Wh are [128, 512] each) next to the FMA
// units, and, for T > 1, the chain of T dependent steps, each a gate
// product, a reduction, the cell math and an exchange of h. The first
// design (one block per 4 rows, weights streamed from L2 on every step)
// lost on all of them: 16 blocks on a 132-SM card, 256 dependent L2 loads
// per thread per step, and both paid again at every step of a sequence.
//
// Design:
//   * A cluster of C blocks (8 at H=128; portable) owns one tile of kRows
//     batch rows, and the batch is cut into tiles, so B=64 runs 16 clusters
//     on 128 SMs. Block r of a cluster owns hidden units [r*U, (r+1)*U),
//     U = H/C, with all four gate columns of each (4U columns).
//   * Its slices of Wx and Wh ((D+H) x 4U floats, 64 KB at H=128) are copied
//     into its shared memory once per launch with cp.async straight from the
//     unpacked [K, 4H] layout (16 B a copy where the strips are aligned), and
//     stay there for all T steps. Everything else the prologue needs (h0,
//     the resets of the whole tile, the bias slice, x_0 and x_1) is copied
//     the same way, so all its loads are in flight at once.
//   * Each thread owns 4 neighbouring gate columns and a K-slice of 4-deep
//     chunks, and accumulates a kRows x 4 register tile from 16-byte
//     shared-memory reads: each weight read serves all rows of the tile,
//     each read of h or x all four columns. Shared-memory bandwidth, not
//     FMA, bounds this product, hence the wide reads.
//   * The K-slices' partial sums are added in a fixed order by all threads
//     at once (one gate pre-activation each); then the thread of each (row,
//     unit) applies the four gates' nonlinearities and updates c, which
//     stays in its register for all T steps.
//   * h moves between steps through distributed shared memory: each block
//     sends its h slice into the double-buffered full-width h tile of every
//     block of the cluster with st.async, which counts the bytes on the
//     receiver's mbarrier. A block waits only for its own tile to be full,
//     never on a cluster-wide barrier, and computes x_{t+1} @ Wx while h is
//     in flight (x is copied in a step ahead). h never goes through
//     device memory between steps. Two buffers suffice: sending h_{t+1}
//     needs h_t from every block, and each block sends h_t only after it
//     has finished reading the buffer that h_{t+1} overwrites.
//   * The sum order is fixed (no atomics, no split-K across blocks), and a
//     row's result depends only on that row's inputs, so padding rows never
//     change a live row's bits.
//
// No tensor cores. The contract is f32 against the plain version at atol
// 1e-5; TF32 keeps 10 mantissa bits (~1e-3 relative) and cannot meet it,
// and the per-step product (kRows x 4U x (D+H) per block) is far too small
// for a wgmma pipeline to pay. bf16 weights or a 3xTF32 split would change
// the contract. The plan (`kernel_plan` in ops/lstm.py) refuses shapes
// whose weight slice and buffers do not fit one block's 227 KB at C <= 8.
//
// Where the time goes (measured on the card; PERF.md): a fixed cost of a
// few microseconds, most of it the issue of the 16-byte copies of the
// weight slice (the per-SM rate of cp.async, not L2 bandwidth, limits it),
// then about 1.6 us a step, spread over the h @ Wh product, the reduction
// of the K-slices, the cell math and the sends.

#include <cuda_runtime.h>
#include <cooperative_groups.h>

#include <c10/cuda/CUDAException.h>

#include <cstdint>
#include <cstdio>
#include <exception>
#include <map>
#include <mutex>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 4;  // batch rows per cluster tile

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared memory of one block, in floats: two mbarriers (4 floats), weights
// [Dp+Hp][4U], x [2][R][Dp], h [2][R][Hp], partial sums [KS][R][4U], gate
// pre-activations [R][4U], bias [4U], resets [R][T]. Dp and Hp are D and H
// rounded up to 4; the rounding rows and columns hold zeros.
__host__ __device__ inline int smem_floats(int D, int H, int T, int R, int U, int KS) {
  const int Dp = round4(D), Hp = round4(H), NC = 4 * U;
  return 4 + (Dp + Hp) * NC + 2 * R * Dp + 2 * R * Hp + KS * R * NC + R * NC + NC + round4(R * T);
}

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// global -> shared, 16 bytes (vec) or 4 bytes, asynchronous
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool vec) {
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// `rows` rows of `n` floats, global row stride `ld`, into shared rows of
// stride `lds`
__device__ __forceinline__ void copy_rows(float* dst, int lds, const float* src, size_t ld,
                                          int rows, int n, bool vec) {
  const int per_row = vec ? n / 4 : n;
  const int width = vec ? 4 : 1;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int k = (i - r * per_row) * width;
    cp_async(dst + r * lds + k, src + r * ld + k, vec);
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// the phase's one local arrival, with the bytes the phase must receive
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

// A wait far longer than any step (about a second) can only be a fault:
// trap, so that the launch fails with an error instead of holding the card.
constexpr long long kWaitLimitCycles = 2000000000LL;

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > kWaitLimitCycles) __trap();
  }
}

// v into block `rank`'s shared memory at the offset `local` has in this
// block, its 4 bytes counted on that block's mbarrier at the offset of `bar`
__device__ __forceinline__ void send(const float* local, uint64_t* bar, unsigned rank, float v) {
  unsigned dst, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(dst) : "r"(smem_addr(local)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(dst), "r"(__float_as_uint(v)), "r"(rbar) : "memory");
}

// acc[r][j] += sum over this thread's chunks of in[r, k] * w[k, 4g + j]:
// chunks c = ks, ks + KS, ... of 4 consecutive k, in order
template <int R>
__device__ __forceinline__ void gate_product(float (&acc)[R][4], const float* in, int Kp,
                                             const float* w, int NC, int g, int ks, int KS) {
  for (int c = ks; c < Kp / 4; c += KS) {
    const int k = 4 * c;
    const float4 w0 = *reinterpret_cast<const float4*>(w + (k + 0) * NC + 4 * g);
    const float4 w1 = *reinterpret_cast<const float4*>(w + (k + 1) * NC + 4 * g);
    const float4 w2 = *reinterpret_cast<const float4*>(w + (k + 2) * NC + 4 * g);
    const float4 w3 = *reinterpret_cast<const float4*>(w + (k + 3) * NC + 4 * g);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(in + r * Kp + k);
      float* a = acc[r];
      a[0] = fmaf(v.x, w0.x, a[0]); a[1] = fmaf(v.x, w0.y, a[1]);
      a[2] = fmaf(v.x, w0.z, a[2]); a[3] = fmaf(v.x, w0.w, a[3]);
      a[0] = fmaf(v.y, w1.x, a[0]); a[1] = fmaf(v.y, w1.y, a[1]);
      a[2] = fmaf(v.y, w1.z, a[2]); a[3] = fmaf(v.y, w1.w, a[3]);
      a[0] = fmaf(v.z, w2.x, a[0]); a[1] = fmaf(v.z, w2.y, a[1]);
      a[2] = fmaf(v.z, w2.z, a[2]); a[3] = fmaf(v.z, w2.w, a[3]);
      a[0] = fmaf(v.w, w3.x, a[0]); a[1] = fmaf(v.w, w3.y, a[1]);
      a[2] = fmaf(v.w, w3.z, a[2]); a[3] = fmaf(v.w, w3.w, a[3]);
    }
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&acc)[R][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.0f;
  }
}

template <int R>
__global__ void lstm_seq_cluster_kernel(
    const float* __restrict__ x,       // [B, T, D]
    const float* __restrict__ h0,      // [B, H]
    const float* __restrict__ c0,      // [B, H]
    const float* __restrict__ wx,      // [D, 4H]
    const float* __restrict__ wh,      // [H, 4H]
    const float* __restrict__ bias,    // [4H]
    const float* __restrict__ resets,  // [B, T]
    float* __restrict__ hs,            // [B, T, H]
    float* __restrict__ hT,            // [B, H]
    float* __restrict__ cT,            // [B, H]
    int B, int T, int D, int H, int KS, int vec_x, int vec_h, int vec_w) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int U = H / C;
  const int NC = 4 * U;
  const int G = 4 * H;
  const int Dp = round4(D), Hp = round4(H);

  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [2]: h tile complete
  float* w = smem + 4;                  // [Dp+Hp][NC]: Wx slice, then Wh slice
  float* xb = w + (Dp + Hp) * NC;       // [2][R][Dp]
  float* hb = xb + 2 * R * Dp;          // [2][R][Hp]
  float* red = hb + 2 * R * Hp;         // [KS][R][NC]
  float* pre = red + KS * R * NC;       // [R][NC]
  float* bsm = pre + R * NC;            // [NC]
  float* rs = bsm + NC;                 // [R][T]

  const int b0 = (blockIdx.x / C) * R;
  const int rows = min(R, B - b0);
  const int tid = threadIdx.x;
  const int g = tid % U;          // product: columns [4g, 4g+4), K-slice ks
  const int ks = tid / U;
  const bool cell = tid < R * U;  // cell update: (row, unit g)
  const int row = tid / U;
  const int unit = rank * U + g;
  const bool live = cell && row < rows;
  const size_t xrow = (size_t)T * D;  // x's batch stride
  const float* xt = x + (size_t)b0 * xrow;

  // -- prologue: every load in flight at once ------------------------------
  if (vec_w) {
    // U copies of 16 B a weight row: thread tid always takes the same one
    const int q = g / (U / 4), j = 4 * (g % (U / 4));
    for (int k = ks; k < D + H; k += KS) {
      const bool is_x = k < D;
      const float* src = (is_x ? wx + (size_t)k * G : wh + (size_t)(k - D) * G) + q * H + rank * U + j;
      cp_async(w + (is_x ? k : Dp + k - D) * NC + q * U + j, src, true);
    }
  } else {
    for (int i = tid; i < (D + H) * NC; i += blockDim.x) {
      const int k = i / NC, col = i - k * NC, q = col / U;
      const bool is_x = k < D;
      const float* src = (is_x ? wx + (size_t)k * G : wh + (size_t)(k - D) * G) + q * H + rank * U + col - q * U;
      cp_async(w + (is_x ? k : Dp + k - D) * NC + col, src, false);
    }
  }
  copy_rows(bsm, U, bias + rank * U, H, 4, U, vec_w);
  copy_rows(xb, Dp, xt, xrow, rows, D, vec_x);
  if (T > 1) copy_rows(xb + R * Dp, Dp, xt + D, xrow, rows, D, vec_x);
  copy_rows(hb, Hp, h0 + (size_t)b0 * H, H, rows, H, vec_h);
  copy_rows(rs, T, resets + (size_t)b0 * T, T, rows, T, false);
  float c = live ? c0[(size_t)(b0 + row) * H + unit] : 0.0f;
  // zeros: the rounding rows of the weights, the rounding columns and the
  // padding rows of x and h, and the padding rows' resets
  for (int i = tid; i < (Dp - D) * NC; i += blockDim.x) w[D * NC + i] = 0.0f;
  for (int i = tid; i < (Hp - H) * NC; i += blockDim.x) w[(Dp + H) * NC + i] = 0.0f;
  for (int i = tid; i < 2 * R * Dp; i += blockDim.x) {
    if ((i / Dp) % R >= rows || i % Dp >= D) xb[i] = 0.0f;
  }
  for (int i = tid; i < 2 * R * Hp; i += blockDim.x) {
    // the padding rows of the second buffer are sent by the cluster
    if ((i < R * Hp && i / Hp >= rows) || i % Hp >= H) hb[i] = 0.0f;
  }
  for (int i = tid; i < (R - rows) * T; i += blockDim.x) rs[rows * T + i] = 0.0f;
  const unsigned tile_bytes = sizeof(float) * R * H;  // h from every block
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (T > 1) mbar_expect(&full[1], tile_bytes);  // for step 1
    if (T > 2) mbar_expect(&full[0], tile_bytes);  // for step 2
  }
  cp_async_wait_all();
  __syncthreads();
  for (int i = tid; i < rows * H; i += blockDim.x) {  // the reset of step 0
    const int r = i / H;
    hb[r * Hp + i - r * H] *= 1.0f - rs[r * T];
  }
  if (live) c *= 1.0f - rs[row * T];
  // every block of the cluster has started and initialised its mbarriers
  // before any block sends it h; this block's staged data is visible to it
  cluster.sync();

  float xacc[R][4];
  zero(xacc);
  gate_product(xacc, xb, Dp, w, NC, g, ks, KS);

  unsigned parity = 0;  // bit b: the phase of full[b] awaited next
  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    if (t > 0) {
      mbar_wait(&full[cur], (parity >> cur) & 1);  // h_t of every block is here
      parity ^= 1u << cur;
      if (tid == 0 && t + 2 < T) mbar_expect(&full[cur], tile_bytes);  // for step t+2
    }
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = xacc[r][j];
    }
    gate_product(acc, hb + cur * R * Hp, Hp, w + Dp * NC, NC, g, ks, KS);
    float* part = red + ks * R * NC + 4 * g;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      *reinterpret_cast<float4*>(part + r * NC) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    if (t + 1 < T) cp_async_wait_all();  // this thread's copies of x_{t+1}
    __syncthreads();

    // gate pre-activations: the K-slices in a fixed order, then the bias
    for (int o = tid; o < R * NC; o += blockDim.x) {
      float s = 0.0f;
#pragma unroll 4
      for (int j = 0; j < KS; ++j) s += red[j * R * NC + o];
      pre[o] = s + bsm[o % NC];
    }
    __syncthreads();

    if (cell) {
      const float* a = pre + row * NC + g;  // i, f, g, o at a[0], a[U], a[2U], a[3U]
      const float i_g = sigmoid_f32(a[0]);
      const float f_g = sigmoid_f32(a[U]);
      const float g_g = tanhf(a[2 * U]);
      const float o_g = sigmoid_f32(a[3 * U]);
      c = f_g * c + i_g * g_g;
      const float h = o_g * tanhf(c);
      if (t + 1 < T) {
        // the next step's reset, applied now: c stays here, h goes to every
        // block of the cluster (this one included)
        const float keep = 1.0f - rs[row * T + t + 1];
        const float* dst = hb + (cur ^ 1) * R * Hp + row * Hp + unit;
        for (int peer = 0; peer < C; ++peer) send(dst, &full[cur ^ 1], peer, h * keep);
        if (live) hs[((size_t)(b0 + row) * T + t) * H + unit] = h;
        c *= keep;
      } else if (live) {
        hs[((size_t)(b0 + row) * T + t) * H + unit] = h;
        hT[(size_t)(b0 + row) * H + unit] = h;
        cT[(size_t)(b0 + row) * H + unit] = c;
      }
    }

    if (t + 1 < T) {
      // x_t's buffer is read by no one now: x_{t+2} goes there; then
      // x_{t+1} @ Wx, all while h_{t+1} is in flight
      if (t + 2 < T) copy_rows(xb + cur * R * Dp, Dp, xt + (size_t)(t + 2) * D, xrow, rows, D, vec_x);
      zero(xacc);
      gate_product(xacc, xb + (cur ^ 1) * R * Dp, Dp, w, NC, g, ks, KS);
    }
  }
  // no block leaves while the cluster's distributed shared memory traffic
  // may be in flight
  if (T > 1) cluster.sync();
}

// Shared-memory attribute and schedulability, checked once per device and
// launch shape.
std::mutex g_configured_lock;
std::map<std::tuple<int, int, int, int>, int> g_configured;
std::map<int, int> g_smem_ceiling;  // device -> the attribute's value

}  // namespace

// Launches the kernel on `stream` with the plan's numbers (see
// `kernel_plan` in ops/lstm.py). Returns 0, or 1 with the reason written to
// `err`: a plan that does not match the shape, a cluster the card cannot
// schedule, a refused launch.
extern "C" int dota_lstm_seq_forward(
    const float* x, const float* h0, const float* c0, const float* wx,
    const float* wh, const float* bias, const float* resets, float* hs,
    float* hT, float* cT, int B, int T, int D, int H, int cluster, int rows,
    int grid, int threads, int smem_bytes, void* stream, char* err, int err_len) {
  try {
    auto kernel = lstm_seq_cluster_kernel<kRows>;
    const int U = (cluster > 0 && H % cluster == 0) ? H / cluster : 0;
    const int KS = U > 0 ? threads / U : 0;
    const bool plan_ok =
        rows == kRows && cluster >= 1 && cluster <= 8 && U > 0 && threads % U == 0 &&
        KS >= kRows && threads <= 1024 && grid == cluster * ((B + kRows - 1) / kRows) &&
        (size_t)smem_bytes == sizeof(float) * (size_t)smem_floats(D, H, T, kRows, U, KS);
    if (!plan_ok) {
      snprintf(err, err_len,
               "plan does not fit the kernel: B=%d T=%d D=%d H=%d cluster=%d rows=%d grid=%d "
               "threads=%d smem=%d",
               B, T, D, H, cluster, rows, grid, threads, smem_bytes);
      return 1;
    }

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem_bytes;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;

    int device = 0;
    C10_CUDA_CHECK(cudaGetDevice(&device));
    int active = 0;
    {
      std::lock_guard<std::mutex> guard(g_configured_lock);
      const auto key = std::make_tuple(device, smem_bytes, threads, cluster);
      auto it = g_configured.find(key);
      if (it == g_configured.end()) {
        // the attribute is a ceiling: raise it, never lower it under a
        // shape configured before
        int& ceiling = g_smem_ceiling[device];
        if (smem_bytes > ceiling) {
          C10_CUDA_CHECK(cudaFuncSetAttribute(
              kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
          ceiling = smem_bytes;
        }
        C10_CUDA_CHECK(cudaOccupancyMaxActiveClusters(&active, kernel, &cfg));
        g_configured[key] = active;
      } else {
        active = it->second;
      }
    }
    if (active < 1) {
      snprintf(err, err_len,
               "a cluster of %d blocks with %d threads and %d bytes of shared memory each "
               "cannot be scheduled on this device",
               cluster, threads, smem_bytes);
      return 1;
    }

    // 16-byte copies where every row start is 16-byte aligned
    const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    const bool vec_x = D % 4 == 0 && aligned(x);
    const bool vec_h = H % 4 == 0 && aligned(h0);
    const bool vec_w = U % 4 == 0 && aligned(wx) && aligned(wh) && aligned(bias);
    C10_CUDA_CHECK(cudaLaunchKernelEx(&cfg, kernel, x, h0, c0, wx, wh, bias, resets, hs, hT, cT,
                                      B, T, D, H, KS, (int)vec_x, (int)vec_h, (int)vec_w));
    C10_CUDA_KERNEL_LAUNCH_CHECK();
    return 0;
  } catch (const c10::Error& e) {
    snprintf(err, err_len, "%s", e.what_without_backtrace());
  } catch (const std::exception& e) {
    snprintf(err, err_len, "%s", e.what());
  }
  return 1;
}
