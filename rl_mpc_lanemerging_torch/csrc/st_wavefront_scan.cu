// Full-scan form of the jerk-limited ST lattice wavefront DP (sm_90a): the
// port's first K1, kept as the yardstick of the redesigned kernel.
//
// Nothing on a path of the port launches it.  chip_smoke.py builds it beside
// csrc/st_wavefront.cu, times it under the same kernel-only CUDA-event
// timing ("earlier_ms") and backtraces its tables as a second check of the
// new kernel's sequences.  Same function as the TPU kernel
// rl_mpc_lanemerging_tpu/ops/st_pallas.py::_kernel: for each of the T-1
// layers and each destination cell j, the minimum over offsets d in
// [0, d_pad) of  c_tot*(d*ds - m)^2 + K + V  from source j-d, taken only
// where d lies in the source's float band [xlo, xhi], ties broken on
// (cost, -d), plus the pre-folded obstacle/distance penalty
// (st_kernel.fold_penalty).  It writes int32 backpointers and each layer's
// min and argmin; st_kernel._backtrace walks them.
//
// Design: one thread block of 1024 threads per scenario, the layer loop
// inside the block, the wavefront (five f32 rows over d_pad + s_pad cells)
// in dynamic shared memory.  Each thread owns destinations j = tid,
// tid + blockDim, ... and scans EVERY offset d in ascending order, so it
// visits every (destination, offset) pair below the reachability bound,
// ~290 times the pairs that lie in a reachable source's band: operations
// bind it.  Built with -fmad=false like the kernel it is held against.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

namespace {

constexpr float kBig = 3e30f;   // the JAX kernel's _BIG sentinel
constexpr int kThreads = 1024;

// Host-computed (in double, then rounded to float) constants: the first 16
// of the wrapper's _kernel_constants.
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

// Lexicographic (value, index) minimum: the smallest index among equal
// minima, as the JAX kernel's amin.
__device__ __forceinline__ void take_min(float& v, int& j, float ov, int oj) {
  if (ov < v || (ov == v && oj < j)) {
    v = ov;
    j = oj;
  }
}

__global__ void __launch_bounds__(kThreads) st_wavefront_scan_kernel(
    const float* __restrict__ pen, const float* __restrict__ v0,
    const float* __restrict__ a0, int32_t* __restrict__ bp,
    float* __restrict__ vmin, int32_t* __restrict__ amin, int num_t,
    int num_s, int s_pad, int d_pad, Consts c) {
  extern __shared__ float smem[];
  const int rows = d_pad + s_pad;
  float* s_mt = smem;
  float* s_k2 = s_mt + rows;
  float* s_u = s_k2 + rows;
  float* s_xlo = s_u + rows;
  float* s_xhi = s_xlo + rows;
  float* st_v = s_xhi + rows;                                // s_pad
  int* st_d = reinterpret_cast<int*>(st_v + s_pad);          // s_pad
  float* st_usel = reinterpret_cast<float*>(st_d + s_pad);   // s_pad
  float* red_v = st_usel + s_pad;                            // 32
  int* red_j = reinterpret_cast<int*>(red_v + 32);           // 32

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* pen_b = pen + static_cast<size_t>(b) * num_t * s_pad;
  int32_t* bp_b = bp + static_cast<size_t>(b) * num_t * s_pad;
  const float inf = __int_as_float(0x7f800000);

  // layer 0 (st_pallas.py _init): only the origin row d_pad is reachable
  const float v0b = v0[b];
  const float a0b = a0[b];
  const float u0 = v0b * c.dt;
  const float w0 = c.dt * (v0b - a0b * c.dt);
  const float b0 = 2.0f * v0b * c.dt - w0;
  for (int r = tid; r < rows; r += nthreads) {
    float mt, k2, xlo, xhi;
    band_and_moments(c, r == d_pad ? 0.0f : kBig, u0, b0, mt, k2, xlo, xhi);
    if (r < d_pad) {          // sources with s < 0: never feasible
      xlo = 1.0f;
      xhi = -1.0f;
    }
    s_mt[r] = mt;
    s_k2[r] = k2;
    s_u[r] = u0;
    s_xlo[r] = xlo;
    s_xhi[r] = xhi;
  }
  for (int j = tid; j < s_pad; j += nthreads) bp_b[j] = 0;
  if (tid == 0) {
    vmin[b * num_t] = 0.0f;
    amin[b * num_t] = 0;
  }
  __syncthreads();

  for (int t = 1; t < num_t; ++t) {
    // layer t can only reach s-indices < d_pad * t + 1
    const int hi = min(d_pad * t + 1, num_s);
    for (int j = tid; j < s_pad; j += nthreads) {
      float best = kBig;
      int bestd = -1;
      float usel = 0.0f;
      if (j < hi) {
        for (int d = 0; d < d_pad; ++d) {
          const int r = j - d + d_pad;
          const float df = static_cast<float>(d);
          if (df >= s_xlo[r] && df <= s_xhi[r]) {
            const float xt = df * c.ds_sq_tot;
            const float diff = xt - s_mt[r];
            const float cand = diff * diff + s_k2[r];
            if (cand < best || (cand == best && d > bestd)) {
              best = cand;
              bestd = d;
              usel = s_u[r];
            }
          }
        }
      }
      float nv = best < kBig ? best + pen_b[t * s_pad + j] : kBig;
      if (j >= num_s) nv = kBig;
      st_v[j] = nv;
      st_d[j] = bestd;
      st_usel[j] = usel;
    }
    __syncthreads();   // every source row of this layer has been read

    float loc_v = inf;
    int loc_j = INT_MAX;
    for (int j = tid; j < s_pad; j += nthreads) {
      const float nv = st_v[j];
      const int bd = st_d[j];
      // u' = d * ds and beta' = 2u' - w', w' the selected source's u
      const float u_new = static_cast<float>(bd) * c.ds;
      const float b_new = 2.0f * u_new - st_usel[j];
      float mt, k2, xlo, xhi;
      band_and_moments(c, nv, u_new, b_new, mt, k2, xlo, xhi);
      const int r = d_pad + j;
      s_mt[r] = mt;
      s_k2[r] = k2;
      s_u[r] = u_new;
      s_xlo[r] = xlo;
      s_xhi[r] = xhi;
      bp_b[t * s_pad + j] = j - bd;            // predecessor index
      take_min(loc_v, loc_j, nv, j);
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, loc_v, off);
      const int oj = __shfl_down_sync(0xffffffffu, loc_j, off);
      take_min(loc_v, loc_j, ov, oj);
    }
    if (lane == 0) {
      red_v[warp] = loc_v;
      red_j[warp] = loc_j;
    }
    __syncthreads();
    if (warp == 0) {
      const int nwarps = nthreads >> 5;
      loc_v = lane < nwarps ? red_v[lane] : inf;
      loc_j = lane < nwarps ? red_j[lane] : INT_MAX;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, loc_v, off);
        const int oj = __shfl_down_sync(0xffffffffu, loc_j, off);
        take_min(loc_v, loc_j, ov, oj);
      }
      if (lane == 0) {
        vmin[b * num_t + t] = loc_v;
        amin[b * num_t + t] = loc_j;
      }
    }
    __syncthreads();   // the new wavefront rows are complete
  }
}

}  // namespace

extern "C" {

int st_wavefront_scan_num_consts() {
  return static_cast<int>(sizeof(Consts) / sizeof(float));
}

size_t st_wavefront_scan_smem_bytes(int s_pad, int d_pad) {
  return sizeof(float) *
         (5 * static_cast<size_t>(d_pad + s_pad) + 3 * s_pad + 64);
}

// Launch on `stream`; allocates nothing.  pen (B, T, s_pad) f32; v0, a0 (B,)
// f32; outputs bp (B, T, s_pad) i32, vmin and amin (B, T).  Returns the CUDA
// error code of the launch (0 on success).
int st_wavefront_scan_launch(const float* pen, const float* v0, const float* a0,
                        int32_t* bp, float* vmin, int32_t* amin, int batch,
                        int num_t, int num_s, int s_pad, int d_pad,
                        const float* consts, void* stream) {
  Consts c;
  std::memcpy(&c, consts, sizeof(Consts));
  const size_t smem = st_wavefront_scan_smem_bytes(s_pad, d_pad);
  cudaError_t err = cudaFuncSetAttribute(
      st_wavefront_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  st_wavefront_scan_kernel<<<batch, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      pen, v0, a0, bp, vmin, amin, num_t, num_s, s_pad, d_pad, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
