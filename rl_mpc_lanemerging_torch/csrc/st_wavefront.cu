// Jerk-limited ST lattice wavefront DP for Hopper (sm_90a): K1 of the port.
//
// Replaces the TPU kernel rl_mpc_lanemerging_tpu/ops/st_pallas.py::_kernel
// (launched by make_pallas_solver through pl.pallas_call) together with the
// penalty fold before it and the backtrace after it.  Same function: for
// each of the T-1 layers and each destination cell j, the minimum over
// offsets d of  c_tot*(d*ds - m)^2 + K + V  from source j-d, taken only
// where d lies in the source's feasible band, ties broken on (cost, -d),
// plus the obstacle/distance penalty of cell j; then the walk back from the
// argmin of the last reachable layer.  One launch maps obstacles (B,T,S)
// bool, distances (B,T,S) f32, s_values (B,S), v0 and a0 (B,) to the s
// sequences (B,T).  Bit-identical to st_kernel.st_wavefront_reference.
//
// What bounds it on this card: latency.  A scenario's input needs a few
// hundred reachable cells per layer and 4-6 in-band offsets per cell, about
// a microsecond of bytes and less of arithmetic for the whole batch.  What
// remains is 17 dependent layers, each a chain of shared-memory reads, one
// shared-memory atomic, two block barriers and one band_and_moments (three
// IEEE divisions) deep: a few thousand cycles per layer whatever the width,
// which the bound (full overlap) cannot see.
//
// Design:
// * one thread block per scenario, the layer loop inside the block (the
//   TPU's sequential grid axis); every per-cell array lives in dynamic
//   shared memory (~153 KB at T=18, s_pad=3008);
// * band-limited sweep, scatter form.  The float band test
//   d >= xlo && d <= xhi over integer d is exactly
//   d in [max(0, ceil(xlo)), min(d_pad-1, floor(xhi))]; the epilogue stores
//   these two integers per cell (an empty band for an unreachable cell), and
//   the sweep gives each reachable source its own offsets only: it pushes
//   candidate (cost, d) to destination j = src + d with a 64-bit
//   shared-memory atomicMin on a packed key -- high word the cost's float
//   bits mapped to unsigned order, low word d_pad-1-d, so that among equal
//   costs the largest d wins.  The minimum does not depend on arrival order,
//   so the result is deterministic.  Scatter was chosen over a gather across
//   the layer's union band because it visits exactly the in-band pairs (the
//   kernel's own counter equals the plain version's count), whereas the
//   union of a layer's bands grows with the spread of speeds across its
//   cells, and contention is low (4-6 candidates per destination).  The
//   64-bit minimum compiles to a compare-and-swap loop; two passes of native
//   32-bit atomics (minimum cost, then maximum d among its ties) with a
//   barrier between were measured within a few percent of it and dropped;
// * the candidates of one source are spread over up to 8 threads when the
//   block has threads to spare, because a thread's candidates are one
//   dependent chain each: measured faster than one thread per source at
//   every block size;
// * reachable window.  The epilogue block-reduces the least src+dlo and the
//   greatest src+dhi over the reachable cells; the next layer's epilogue,
//   input reads and key reset run over that window only, and the sweep
//   after it takes its sources from it (unreachable cells inside it carry an
//   empty band).  Cells outside are unreachable by construction.  An empty
//   window ends the layer loop;
// * penalty fold in the kernel, with the operations of
//   st_kernel.fold_penalty in their order; no penalty tensor exists;
// * prefetch.  A layer's window is known when its sweep begins, so each
//   thread starts the plain loads of its cells' obstacle bytes and distances
//   into registers before the sweep and uses them after it: the counterpart
//   of the TPU kernel's pen_dma.start()/.wait().  Rows of S obstacle bytes
//   are not 4-byte aligned, which byte loads do not mind.  A cp.async double
//   buffer in shared memory that ran one layer ahead (over a superset of the
//   next window, with aligned-word copies of the obstacle bytes) was built
//   and measured no faster, and cost 30 KB and its alignment code;
// * backpointers are the chosen offsets d (< 256) as bytes in shared memory,
//   (T-1) x s_pad.  Each layer keeps its settled values (two buffers, by
//   layer parity); after the last layer the block takes the argmin of the
//   last layer that has a reachable cell, one thread walks back from it as
//   st_kernel._backtrace does, and T threads write s_values at the path;
// * an optional counter receives the (source, offset) pairs visited, one
//   atomicAdd per block.
//
// The block size comes from the wrapper (1024, the fastest of 256, 512 and
// 1024 measured: every cell and candidate its own thread).  One block fits
// an SM; with B=128 blocks on 132 SMs the card is under-filled, and larger
// batches run in waves.  Built with -fmad=false so that every float
// operation is the one the plain PyTorch version performs; host constants
// are computed in double and rounded once.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

namespace {

using u64 = unsigned long long;

constexpr float kBig = 3e30f;   // the JAX kernel's _BIG sentinel
constexpr int kMaxThreads = 1024;
constexpr u64 kNoKey = ~0ull;   // no candidate / no reachable cell

// Host-computed (in double, then rounded to float) constants; the order is
// the wrapper's _kernel_constants order.
struct Consts {
  float dt;          // delta_t
  float inv_ds;      // 1 / delta_s
  float ds;          // delta_s
  float c_a;         // a_weight / dt^4
  float c_j;         // j_weight / dt^6
  float c_v;         // v_weight / dt^2
  float cvd;         // c_v * desired_speed * dt
  float big_d;       // desired_speed * dt
  float inv_c_tot;   // 1 / (c_a + c_j + c_v)
  float sq_tot;      // sqrt(c_tot)
  float ds_sq_tot;   // delta_s * sqrt(c_tot)
  float njl_dt;      // negative_jerk_limit * dt
  float pjl_dt;      // positive_jerk_limit * dt
  float nal;         // negative_acceleration_limit
  float pal;         // positive_acceleration_limit
  float max_speed;
  float d_weight;
  float min_allowed; // min_allowed_distance
};

// Per-source quantities of the offset sweep (st_pallas.py band_and_moments):
// the weighted-variance identity
//   c_a (x-u)^2 + c_j (x-beta)^2 + c_v (x-D)^2 = c_tot (x-m)^2 + K
// with the carried value folded into k2 = K + V and m pre-scaled by
// sqrt(c_tot), and the feasible band as float displacement thresholds.
__device__ __forceinline__ void band_and_moments(
    const Consts& c, float vcur, float u, float beta,
    float& mt, float& k2, float& xlo, float& xhi) {
  const float wv = 2.0f * u - beta;
  const float v = u / c.dt;
  const float prev_v = wv / c.dt;
  const float a = (v - prev_v) / c.dt;
  const float min_a = fmaxf(a + c.njl_dt, c.nal);
  const float max_a = fminf(a + c.pjl_dt, c.pal);
  const float min_v = fmaxf(v + min_a * c.dt, 0.0f);
  const float max_v = fminf(v + max_a * c.dt, c.max_speed);
  xlo = min_v * c.dt * c.inv_ds;
  xhi = max_v * c.dt * c.inv_ds;
  const float m = (c.c_a * u + c.c_j * beta + c.cvd) * c.inv_c_tot;
  const float eu = u - m;
  const float eb = beta - m;
  const float ed = c.big_d - m;
  const float k = c.c_a * (eu * eu) + c.c_j * (eb * eb) + c.c_v * (ed * ed);
  mt = m * c.sq_tot;
  k2 = k + vcur;
}

// The integer offsets of the float band: {d : d >= xlo && d <= xhi} over
// d in [0, d_pad) is [ceil(xlo), floor(xhi)] clamped, the clamp taken on the
// floats before the conversion.  (1, 0) stands for every empty band: xlo >
// xhi, a NaN threshold, or a band wholly below 0 or above d_pad-1.
__device__ __forceinline__ uchar2 integer_band(float xlo, float xhi,
                                               int d_pad) {
  if (!(xlo <= xhi)) return make_uchar2(1, 0);
  const float lo = fminf(fmaxf(ceilf(xlo), 0.0f), static_cast<float>(d_pad));
  const float hi =
      fminf(fmaxf(floorf(xhi), -1.0f), static_cast<float>(d_pad - 1));
  const int ilo = static_cast<int>(lo);
  const int ihi = static_cast<int>(hi);
  if (ilo > ihi) return make_uchar2(1, 0);
  return make_uchar2(static_cast<unsigned char>(ilo),
                     static_cast<unsigned char>(ihi));
}

// Float bits mapped so that unsigned integer order is float order.
__device__ __forceinline__ uint32_t order_bits(float x) {
  const uint32_t b = __float_as_uint(x);
  return b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : 0xffffffffu));
}

// Loads pinned where they are written (volatile): started before the sweep,
// consumed after it.
__device__ __forceinline__ float load_f32_early(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned load_u8_early(const uint8_t* p) {
  unsigned v;
  asm volatile("ld.global.nc.u8 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

constexpr int kRegCells = 3;   // window cells a thread prefetches per layer

__global__ void __launch_bounds__(kMaxThreads) st_wavefront_kernel(
    const uint8_t* __restrict__ obs, const float* __restrict__ dist,
    const float* __restrict__ s_values, const float* __restrict__ v0,
    const float* __restrict__ a0, float* __restrict__ out,
    u64* __restrict__ visited, int num_t, int num_s, int s_pad, int d_pad,
    Consts c) {
  // the carve below is st_wavefront_smem_bytes term by term
  extern __shared__ __align__(16) unsigned char smem_raw[];
  u64* s_key = reinterpret_cast<u64*>(smem_raw);              // s_pad
  u64* s_best = s_key + s_pad;                                // 1
  u64* s_count = s_best + 1;                                  // 1
  float* s_mt = reinterpret_cast<float*>(s_count + 1);        // s_pad
  float* s_k2 = s_mt + s_pad;                                 // s_pad
  float* s_u0 = s_k2 + s_pad;                                 // 2 x s_pad
  float* s_nv0 = s_u0 + 2 * s_pad;                            // 2 x s_pad
  int* s_wlo = reinterpret_cast<int*>(s_nv0 + 2 * s_pad);     // num_t + 1
  int* s_whi = s_wlo + (num_t + 1);
  int* s_any = s_whi + (num_t + 1);
  int* s_idx = s_any + (num_t + 1);
  uchar2* s_band = reinterpret_cast<uchar2*>(s_idx + (num_t + 1));  // s_pad
  uint8_t* s_bp = reinterpret_cast<uint8_t*>(s_band + s_pad);  // (T-1) s_pad

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const unsigned full = 0xffffffffu;
  const size_t row0 = static_cast<size_t>(b) * num_t;

  for (int j = tid; j < s_pad; j += nthreads) s_key[j] = kNoKey;
  for (int t = tid; t <= num_t; t += nthreads) {
    s_wlo[t] = INT_MAX;
    s_whi[t] = -1;
    s_any[t] = 0;
  }
  if (tid == 0) {
    *s_best = kNoKey;
    *s_count = 0;
  }
  __syncthreads();

  // layer 0 (st_pallas.py _init): only the origin cell is reachable
  if (tid == 0) {
    const float v0b = v0[b];
    const float a0b = a0[b];
    const float u0 = v0b * c.dt;
    const float w0 = c.dt * (v0b - a0b * c.dt);
    const float b0 = 2.0f * v0b * c.dt - w0;
    float mt, k2, xlo, xhi;
    band_and_moments(c, 0.0f, u0, b0, mt, k2, xlo, xhi);
    const uchar2 band = integer_band(xlo, xhi, d_pad);
    s_mt[0] = mt;
    s_k2[0] = k2;
    s_u0[0] = u0;
    s_band[0] = band;
    s_wlo[0] = 0;
    s_whi[0] = 0;
    if (band.x <= band.y) {
      s_wlo[1] = band.x;
      s_whi[1] = band.y;
    }
  }
  __syncthreads();

  unsigned pairs = 0;
  int last_t = 0;   // the last layer with a reachable cell
  for (int t = 1; t < num_t; ++t) {
    // layer t's destinations, from the bands of layer t-1
    const int wlo = s_wlo[t];
    const int whi = min(s_whi[t], num_s - 1);
    if (wlo > whi) break;   // nothing reachable from here on
    const float* dist_row = dist + (row0 + t) * num_s;
    const uint8_t* obs_row = obs + (row0 + t) * num_s;
    float dist_reg[kRegCells];
    unsigned obs_reg[kRegCells];
#pragma unroll
    for (int k = 0; k < kRegCells; ++k) {
      const int j = wlo + tid + k * nthreads;
      if (j <= whi) {
        dist_reg[k] = load_f32_early(dist_row + j);
        obs_reg[k] = load_u8_early(obs_row + j);
      }
    }
    const float* u_cur = s_u0 + ((t - 1) & 1) * s_pad;
    float* u_nxt = s_u0 + (t & 1) * s_pad;
    float* nv_t = s_nv0 + (t & 1) * s_pad;

    // sweep: every reachable source pushes its in-band candidates; the
    // sources lie inside layer t-1's window, unreachable ones have no band
    const int slo = s_wlo[t - 1];
    const int shi = min(s_whi[t - 1], num_s - 1);
    // `lanes` threads share a source, each taking every lanes-th offset of
    // its band: as many (a power of two, at most 8) as the block can spare
    int lane_bits = 0;
    while (lane_bits < 3 && ((shi - slo + 1) << (lane_bits + 1)) <= nthreads)
      ++lane_bits;
    const int lanes = 1 << lane_bits;
    const int slots = (shi - slo + 1) << lane_bits;
    for (int q = tid; q < slots; q += nthreads) {
      const int i = slo + (q >> lane_bits);
      const uchar2 band = s_band[i];
      const float mt = s_mt[i];
      const float k2 = s_k2[i];
      const int dhi = min(static_cast<int>(band.y), num_s - 1 - i);
      for (int d = band.x + (q & (lanes - 1)); d <= dhi; d += lanes) {
        const float xt = static_cast<float>(d) * c.ds_sq_tot;
        const float diff = xt - mt;
        const float cand = diff * diff + k2;
        if (cand < kBig)
          atomicMin(&s_key[i + d],
                    (static_cast<u64>(order_bits(cand)) << 32) |
                        static_cast<uint32_t>(d_pad - 1 - d));
        ++pairs;
      }
    }
    __syncthreads();

    // epilogue: penalty, the new wavefront, backpointers, the next window
    uint8_t* bp_t = s_bp + static_cast<size_t>(t - 1) * s_pad;
    int nwlo = INT_MAX, nwhi = -1;
    auto settle = [&](int j, float dj, unsigned blocked) {
      const u64 key = s_key[j];
      const bool have = key != kNoKey;
      uchar2 band = make_uchar2(1, 0);
      float nv = kBig;
      if (have) {
        s_key[j] = kNoKey;
        const float best = from_order_bits(static_cast<uint32_t>(key >> 32));
        const int d = d_pad - 1 - static_cast<int>(key & 0xffffffffu);
        // st_kernel.fold_penalty, op for op
        float pen = dj < c.min_allowed ? (1.0f / fmaxf(dj, 1.0f)) * 1e6f
                                       : 1.0f / dj;
        pen = c.d_weight * pen;
        if (blocked) pen = kBig;
        nv = best + pen;
        if (nv < kBig) {
          // u' = d * ds and beta' = 2u' - w', w' the selected source's u
          const float u_new = static_cast<float>(d) * c.ds;
          const float b_new = 2.0f * u_new - u_cur[j - d];
          float mt, k2, xlo, xhi;
          band_and_moments(c, nv, u_new, b_new, mt, k2, xlo, xhi);
          band = integer_band(xlo, xhi, d_pad);
          s_mt[j] = mt;
          s_k2[j] = k2;
          u_nxt[j] = u_new;
          bp_t[j] = static_cast<uint8_t>(d);
          s_any[t] = 1;   // every writer stores the same value
          if (band.x <= band.y) {
            nwlo = min(nwlo, j + band.x);
            nwhi = max(nwhi, j + band.y);
          }
        } else {
          nv = kBig;
        }
      }
      nv_t[j] = nv;
      s_band[j] = band;
    };
    int j = wlo + tid;
#pragma unroll
    for (int k = 0; k < kRegCells; ++k, j += nthreads)
      if (j <= whi) settle(j, dist_reg[k], obs_reg[k]);
    for (; j <= whi; j += nthreads) settle(j, dist_row[j], obs_row[j]);
    nwlo = __reduce_min_sync(full, nwlo);
    nwhi = __reduce_max_sync(full, nwhi);
    if (lane == 0 && nwlo <= nwhi) {
      atomicMin(&s_wlo[t + 1], nwlo);
      atomicMax(&s_whi[t + 1], nwhi);
    }
    __syncthreads();   // the new wavefront and its window are complete
    if (s_any[t]) last_t = t;
  }
  if (visited != nullptr && pairs != 0)
    atomicAdd(s_count, static_cast<u64>(pairs));

  // the argmin of the last layer with a reachable cell, the smallest index
  // among equal minima (its values are intact: a later layer, if any, wrote
  // the other buffer and had no successor)
  if (last_t > 0) {
    const float* nv_l = s_nv0 + (last_t & 1) * s_pad;
    const int whi = min(s_whi[last_t], num_s - 1);
    uint32_t vbits = 0xffffffffu;
    int vj = INT_MAX;
    for (int j = s_wlo[last_t] + tid; j <= whi; j += nthreads) {
      const float nv = nv_l[j];
      const uint32_t ob = order_bits(nv);
      if (nv < kBig && ob < vbits) {   // j ascends within a thread
        vbits = ob;
        vj = j;
      }
    }
    const uint32_t wv = __reduce_min_sync(full, vbits);
    vj = __reduce_min_sync(full, vbits == wv ? vj : INT_MAX);
    if (lane == 0 && vj != INT_MAX)
      atomicMin(s_best, (static_cast<u64>(wv) << 32) |
                            static_cast<uint32_t>(vj));
  }
  __syncthreads();

  // backtrace (st_kernel._backtrace): from that argmin back to layer 0;
  // -1 marks the layers past it
  if (tid == 0) {
    int idx = last_t > 0 ? static_cast<int>(*s_best & 0xffffffffu) : 0;
    for (int t = num_t - 1; t >= 1; --t) {
      if (t <= last_t) {
        s_idx[t] = idx;
        idx -= s_bp[static_cast<size_t>(t - 1) * s_pad + idx];
      } else {
        s_idx[t] = -1;
      }
    }
    s_idx[0] = idx;
    if (visited != nullptr) atomicAdd(visited, *s_count);
  }
  __syncthreads();
  for (int t = tid; t < num_t; t += nthreads) {
    const int idx = s_idx[t];
    out[row0 + t] =
        idx >= 0 ? s_values[static_cast<size_t>(b) * num_s + idx] : 0.0f;
  }
}

}  // namespace

extern "C" {

int st_wavefront_num_consts() {
  return static_cast<int>(sizeof(Consts) / sizeof(float));
}

// Dynamic shared memory of one block, in the kernel's carve order.
size_t st_wavefront_smem_bytes(int num_t, int s_pad) {
  const size_t s = static_cast<size_t>(s_pad);
  const size_t t = static_cast<size_t>(num_t);
  return sizeof(u64) * (s + 2)              // keys, argmin, counter
         + sizeof(float) * 6 * s            // mt, k2, u x 2, values x 2
         + sizeof(int) * 4 * (t + 1)        // windows, flags, path indices
         + sizeof(uchar2) * s               // integer bands
         + (t - 1) * s;                     // backpointers
}

// Launch on `stream`; allocates nothing.  obs (B, T, S) one byte per cell;
// dist (B, T, S), s_values (B, S), v0, a0 (B,) f32, all contiguous; out
// (B, T) f32; visited null or one u64 the blocks add their visited pairs
// to.  Needs d_pad <= 256 and threads a multiple of 32, at most 1024.
// Returns the CUDA error code of the launch (0 on success).
int st_wavefront_launch(const void* obs, const float* dist,
                        const float* s_values, const float* v0,
                        const float* a0, float* out, void* visited, int batch,
                        int num_t, int num_s, int s_pad, int d_pad,
                        int threads, const float* consts, void* stream) {
  if (d_pad > 256 || threads % 32 != 0 || threads < 32 ||
      threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  Consts c;
  std::memcpy(&c, consts, sizeof(Consts));
  const size_t smem = st_wavefront_smem_bytes(num_t, s_pad);
  static size_t allowed[64] = {};   // per device: raised once, not per launch
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  size_t& allowed_smem = allowed[device];
  if (smem > allowed_smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        st_wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed_smem = smem;
  }
  st_wavefront_kernel<<<batch, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(obs), dist, s_values, v0, a0, out,
      static_cast<u64*>(visited), num_t, num_s, s_pad, d_pad, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
