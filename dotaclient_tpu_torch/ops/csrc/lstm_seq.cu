// Whole-sequence LSTM forward for Hopper (sm_90a): one thread-block cluster
// per tile of batch rows, or, for the shapes a cluster cannot hold, one
// cooperative grid over the whole card (the second kernel, further down).
//
// Both replace the Pallas TPU kernel `_kernel` launched by `_pallas_forward`
// in dotaclient_tpu/ops/pallas/lstm.py. Same function, same contract: for each
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
// the contract. The plan (`kernel_plan` in ops/lstm.py) takes this kernel
// for every shape whose weight slice and buffers fit one block's 227 KB at
// C <= 8, and the grid-wide kernel below for every other shape.
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

// -- the grid-wide kernel -----------------------------------------------------
//
// Every shape the cluster plan refuses: any H whose weight slice does not
// fit one block at a cluster of 8 or less (at D = H, 910 of the first 1,024
// widths: every H above 216, among them 256, 512 and 1,024, every odd H from
// 79 up, and even widths whose largest portable cluster is small), any D,
// and any T (the cluster kernel keeps the tile's resets whole in shared
// memory). Same function, same contract, same cell math as above.
//
// Design: the Pallas kernel's "weights pinned across all T steps" spread
// over the whole card instead of one cluster.
//   * One persistent cooperative launch of at most one block an SM. The
//     hidden units are split over the grid, U a block (U = ceil(H / 132)):
//     block j owns units [jU, jU+U) and their four gate columns (4U). A
//     cooperative launch is refused when the grid cannot be co-resident, so
//     the grid-wide barrier never waits on a block that is not running.
//   * Where its (D+H) x 4U weight slice fits beside the buffers (resident),
//     a block copies it into shared memory once and keeps it for all T steps
//     (64 KB at D = H = 512); otherwise (D = H above ~900) it reads the slice
//     from global memory every step, where the 50 MB L2 holds the whole f32
//     weights up to H ~ 1,250.
//   * h goes between steps through device memory: step t reads h_{t-1} from
//     hs[:, t-1], which every block wrote at step t-1, after one grid-wide
//     barrier a step, with ld.global.cg (L2; the SM's L1 is not coherent
//     across SMs, and a line of hs[:, t] may sit in it from a read of the
//     neighbouring hs[:, t-1]). c lives in cT, each element read and written
//     by the thread of its (row, unit) only.
//   * The batch is walked in tiles of R rows (R = 1..8 by B). For each tile
//     the rows' inputs [x_t, h_{t-1} * keep] are staged into shared memory
//     in chunks of KC of the padded K = D+H axis. Each thread owns one gate
//     column (or a few, where 4U exceeds the column threads) and a K-slice
//     of 4-deep chunks, and accumulates its R rows from 16-byte reads of the
//     staged inputs. Resets are read a step at a time from global memory, so
//     T has no limit but memory.
//   * The sum order is fixed: each thread's slice in order, chunk after
//     chunk, then the K-slices in order, then the bias. No atomics, no
//     split-K across blocks, and a row's sums never touch another row's: its
//     bits do not depend on the other rows, nor on B or R.
//
// What bounds it: at B=64 T=1 D=H=512 the work is 268 MFLOP against 8.4 MB
// of weights, about 4 us at the card's f32 peak; the kernel is far from it.
// Its limits are latencies, paid one after another: the prologue's weight
// load, then for each tile the staging from L2, the product, three block
// barriers, the K-slices' sums and the cell's round trip to cT, and one
// grid barrier a step. More threads a block shorten each thread's chain
// of loads (the K-slices), hence 512; at R=16 the accumulators spill
// (ptxas) and a launch took longer than at R=8 (PERF.md), hence R <= 8.
// Simple and right first: no tensor cores (the f32 contract, as above), no
// TMA, no overlap of one tile's staging with another's product, and every
// block reads the whole [B, D+H] input of a step.

// Shared memory of one block, in floats: the weight slice [Kp][NC] when
// resident, the staged inputs [R][KC], partial sums [KS][R][NC], gate
// pre-activations [R][NC] and the bias slice [NC].
__host__ __device__ inline long long grid_smem_floats(int D, int H, int R, int U, int KS, int KC, int resident) {
  const long long Kp = round4(D) + round4(H), NC = 4LL * U;
  return (resident ? Kp * NC : 0) + (long long)R * KC + (long long)KS * R * NC + R * NC + NC;
}

// the weight of gate column `col` of the block whose first unit is u0, at
// row k of the padded K axis (x rows [0, Dp), h rows [Dp, Dp+Hp)); zero in
// the rounding rows and past H
__device__ __forceinline__ float grid_weight(const float* __restrict__ wx, const float* __restrict__ wh,
                                             int D, int H, int Dp, int U, int u0, int k, int col) {
  const int q = col / U, unit = u0 + col - q * U;
  if (unit >= H) return 0.0f;
  const size_t G = 4 * (size_t)H, offset = (size_t)q * H + unit;
  if (k < Dp) return k < D ? __ldg(wx + (size_t)k * G + offset) : 0.0f;
  return k - Dp < H ? __ldg(wh + (size_t)(k - Dp) * G + offset) : 0.0f;
}

// input k (of the padded K axis) of batch row b (< B) at step t: x_t, or
// h_{t-1} * (1 - reset_t) (the reset, BEFORE the step); zero in the
// rounding rows of K
__device__ __forceinline__ float grid_input(const float* __restrict__ x, const float* __restrict__ h0,
                                            const float* hs, const float* __restrict__ resets, int b, int T,
                                            int D, int H, int Dp, int t, int k) {
  const size_t bt = (size_t)b * T + t;
  if (k < Dp) return k < D ? __ldg(x + bt * D + k) : 0.0f;
  const int kh = k - Dp;
  if (kh >= H) return 0.0f;
  return (t == 0 ? __ldg(h0 + (size_t)b * H + kh) : __ldcg(hs + (bt - 1) * H + kh)) * (1.0f - __ldg(resets + bt));
}

// weight loads a thread keeps in flight in the prologue: each is a separate
// 4-byte read, so one at a time would pay its latency every time
constexpr int kInFlight = 8;

// threads a block at most (GRID_THREADS in ops/lstm.py): the register cap
// that keeps one block an SM schedulable whatever R is
constexpr int kGridMaxThreads = 512;

template <int R>
__global__ void __launch_bounds__(kGridMaxThreads) lstm_seq_grid_kernel(
    const float* __restrict__ x,       // [B, T, D]
    const float* __restrict__ h0,      // [B, H]
    const float* __restrict__ c0,      // [B, H]
    const float* __restrict__ wx,      // [D, 4H]
    const float* __restrict__ wh,      // [H, 4H]
    const float* __restrict__ bias,    // [4H]
    const float* __restrict__ resets,  // [B, T]
    float* hs,                         // [B, T, H]: written, and read a step later
    float* __restrict__ hT,            // [B, H]
    float* cT,                         // [B, H]: c between steps
    int B, int T, int D, int H, int U, int KS, int KC, int resident) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int NC = 4 * U;
  const int Dp = round4(D), Kp = Dp + round4(H);
  const int u0 = blockIdx.x * U;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int NCT = nthreads / KS;           // column threads
  const int colt = tid % NCT, ks = tid / NCT;
  float* w = smem;                                   // [Kp][NC], when resident
  float* in = w + (resident ? (size_t)Kp * NC : 0);  // [R][KC]
  float* red = in + R * KC;                          // [KS][R][NC]
  float* pre = red + KS * R * NC;                    // [R][NC]
  float* bsm = pre + R * NC;                         // [NC]

  for (int col = tid; col < NC; col += nthreads) {
    const int q = col / U, unit = u0 + col - q * U;
    bsm[col] = unit < H ? bias[(size_t)q * H + unit] : 0.0f;
  }
  if (resident) {
    const int n = Kp * NC;
    for (int i0 = tid; i0 < n; i0 += kInFlight * nthreads) {
      float v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = i0 + u * nthreads, k = i / NC;
        v[u] = i < n ? grid_weight(wx, wh, D, H, Dp, U, u0, k, i - k * NC) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (i0 + u * nthreads < n) w[i0 + u * nthreads] = v[u];
      }
    }
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int b0 = 0; b0 < B; b0 += R) {
      for (int kc = 0; kc < Kp; kc += KC) {
        const int kn = min(KC, Kp - kc);  // a multiple of 4, as Kp and KC are
        if (kc > 0) __syncthreads();      // the last chunk's products are done with `in`
        // the R rows' loads of one K index in flight together
        for (int kk = tid; kk < kn; kk += nthreads) {
          float v[R];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            v[r] = b0 + r < B ? grid_input(x, h0, hs, resets, b0 + r, T, D, H, Dp, t, kc + kk) : 0.0f;
          }
#pragma unroll
          for (int r = 0; r < R; ++r) in[r * KC + kk] = v[r];
        }
        __syncthreads();
        for (int col = colt; col < NC; col += NCT) {
          float acc[R];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll 4
          for (int c = ks; c < kn / 4; c += KS) {
            const int k = kc + 4 * c;
            float wk[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              wk[j] = resident ? w[(k + j) * NC + col] : grid_weight(wx, wh, D, H, Dp, U, u0, k + j, col);
            }
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float4 v = *reinterpret_cast<const float4*>(in + r * KC + 4 * c);
              acc[r] = fmaf(v.x, wk[0], acc[r]);
              acc[r] = fmaf(v.y, wk[1], acc[r]);
              acc[r] = fmaf(v.z, wk[2], acc[r]);
              acc[r] = fmaf(v.w, wk[3], acc[r]);
            }
          }
          float* part = red + ks * R * NC + col;  // this thread's own, chunk after chunk
#pragma unroll
          for (int r = 0; r < R; ++r) part[r * NC] = kc == 0 ? acc[r] : part[r * NC] + acc[r];
        }
      }
      __syncthreads();

      // gate pre-activations: the K-slices in a fixed order, then the bias
      for (int o = tid; o < R * NC; o += nthreads) {
        float s = 0.0f;
#pragma unroll 8
        for (int j = 0; j < KS; ++j) s += red[j * R * NC + o];
        pre[o] = s + bsm[o % NC];
      }
      __syncthreads();

      for (int i = tid; i < R * U; i += nthreads) {
        const int r = i / U, j = i - r * U, b = b0 + r, unit = u0 + j;
        if (b < B && unit < H) {
          const size_t bt = (size_t)b * T + t, bu = (size_t)b * H + unit;
          const float* a = pre + r * NC + j;  // i, f, g, o at a[0], a[U], a[2U], a[3U]
          const float i_g = sigmoid_f32(a[0]);
          const float f_g = sigmoid_f32(a[U]);
          const float g_g = tanhf(a[2 * U]);
          const float o_g = sigmoid_f32(a[3 * U]);
          const float keep = 1.0f - __ldg(resets + bt);
          const float c = f_g * ((t == 0 ? __ldg(c0 + bu) : cT[bu]) * keep) + i_g * g_g;
          const float h = o_g * tanhf(c);
          hs[bt * H + unit] = h;
          cT[bu] = c;
          if (t == T - 1) hT[bu] = h;
        }
      }
      // the next tile writes `in` before a barrier, but every read of it
      // here came before the barrier ahead of the pre-activations; `red` and
      // `pre` are written only after the next tile's first barrier
    }
    if (t + 1 < T) grid.sync();  // h_t of every unit is in hs[:, t]
  }
}

using GridKernel = void (*)(const float*, const float*, const float*, const float*, const float*,
                            const float*, const float*, float*, float*, float*, int, int, int, int, int,
                            int, int, int);

GridKernel grid_kernel(int rows) {
  switch (rows) {
    case 1: return lstm_seq_grid_kernel<1>;
    case 2: return lstm_seq_grid_kernel<2>;
    case 4: return lstm_seq_grid_kernel<4>;
    case 8: return lstm_seq_grid_kernel<8>;
    default: return nullptr;
  }
}

// Shared-memory attribute and schedulability, checked once per device and
// launch shape.
std::mutex g_configured_lock;
std::map<std::tuple<int, int, int, int>, int> g_configured;
std::map<int, int> g_smem_ceiling;  // device -> the attribute's value
// the grid kernel's: (device, rows, smem, threads) -> co-resident blocks,
// and (device, rows) -> the attribute's value
std::map<std::tuple<int, int, int, int>, long long> g_grid_configured;
std::map<std::pair<int, int>, int> g_grid_smem_ceiling;

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

// Launches the grid-wide kernel on `stream` with the plan's numbers (see
// `kernel_plan` in ops/lstm.py) as one cooperative launch. Returns 0, or 1
// with the reason written to `err`: a plan that does not match the shape, a
// grid that cannot be co-resident on this device, a refused launch.
extern "C" int dota_lstm_seq_grid_forward(
    const float* x, const float* h0, const float* c0, const float* wx,
    const float* wh, const float* bias, const float* resets, float* hs,
    float* hT, float* cT, int B, int T, int D, int H, int rows, int grid,
    int threads, int units, int kslices, int kchunk, int resident, int smem_bytes,
    void* stream, char* err, int err_len) {
  try {
    const GridKernel kernel = grid_kernel(rows);
    const bool plan_ok =
        kernel != nullptr && units >= 1 && grid == (H + units - 1) / units && kslices >= 1 &&
        threads % kslices == 0 && threads <= kGridMaxThreads && threads / kslices >= 1 &&
        threads / kslices <= 4 * units && kchunk >= 4 && kchunk % 4 == 0 &&
        kchunk <= round4(D) + round4(H) && (resident == 0 || resident == 1) &&
        (long long)smem_bytes == 4 * grid_smem_floats(D, H, rows, units, kslices, kchunk, resident);
    if (!plan_ok) {
      snprintf(err, err_len,
               "plan does not fit the grid kernel: B=%d T=%d D=%d H=%d rows=%d grid=%d threads=%d "
               "units=%d kslices=%d kchunk=%d resident=%d smem=%d",
               B, T, D, H, rows, grid, threads, units, kslices, kchunk, resident, smem_bytes);
      return 1;
    }

    int device = 0;
    C10_CUDA_CHECK(cudaGetDevice(&device));
    long long capacity = 0;
    {
      std::lock_guard<std::mutex> guard(g_configured_lock);
      const auto key = std::make_tuple(device, rows, smem_bytes, threads);
      auto it = g_grid_configured.find(key);
      if (it == g_grid_configured.end()) {
        int& ceiling = g_grid_smem_ceiling[std::make_pair(device, rows)];
        if (smem_bytes > ceiling) {
          C10_CUDA_CHECK(cudaFuncSetAttribute(
              kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
          ceiling = smem_bytes;
        }
        int per_sm = 0, sms = 0;
        C10_CUDA_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem_bytes));
        C10_CUDA_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
        capacity = (long long)per_sm * sms;
        g_grid_configured[key] = capacity;
      } else {
        capacity = it->second;
      }
    }
    if (capacity < grid) {
      snprintf(err, err_len,
               "a grid of %d blocks with %d threads and %d bytes of shared memory each cannot be "
               "co-resident on this device (%lld can)",
               grid, threads, smem_bytes, capacity);
      return 1;
    }

    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem_bytes;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    C10_CUDA_CHECK(cudaLaunchKernelEx(&cfg, kernel, x, h0, c0, wx, wh, bias, resets, hs, hT, cT,
                                      B, T, D, H, units, kslices, kchunk, resident));
    C10_CUDA_KERNEL_LAUNCH_CHECK();
    return 0;
  } catch (const c10::Error& e) {
    snprintf(err, err_len, "%s", e.what_without_backtrace());
  } catch (const std::exception& e) {
    snprintf(err, err_len, "%s", e.what());
  }
  return 1;
}
