// The planner's obstacle grid in one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds the grid in XLA
// (rl_mpc_lanemerging_tpu/planner/grid.py build_st_grid, a lax.scan of its
// forecaster over the slices).  The port's plain path
// (planner/grid.py build_st_grid_plain) rolls the traffic with
// prediction.predict_step_without_ego, a Python loop over the K sensed
// slots for each of the T-1 forecast steps, and marks every slice with
// _mark_slice, which broadcasts it into (B, K, S) tensors.  On the card that
// is ~11,800 small launches a build and a dozen elementwise passes over
// 1.57 GB tensors a slice.  This kernel builds the same STGrid in one
// launch: obstacles (B, T, S) bool, distances (B, T, S) f32, s_values
// (B, S) f32 and t_values (T,) f32, bit for bit those of the plain path on
// the card.
//
// What bounds it on this card: the marking's arithmetic and the grid's
// bytes.  Each cell takes a distance minimum and a band test over the
// slice's active cars (about a dozen), and the grid it writes is 5 bytes a
// cell (1.1 GB at B=4096, T=18, S=3001: 0.33 ms at 3.35 TB/s).  The roll
// itself is a few thousand dependent scalar steps a scenario: latency,
// hidden behind the other blocks' marking on the same SM.
//
// Design:
// * one block per scenario.  Thread 0 rolls the scenario's traffic through
//   the T-1 steps of predict_step_without_ego: the three cases of the
//   virtual ego, its straight move toward merge_point2, and the leader
//   chain over the K slots in slot order (slots are not assumed sorted;
//   absent slots sit at -inf and are masked as the plain path masks them).
//   As each slot is rolled it lands, if active in that slice, in the
//   slice's list in shared memory: its obstacle s and its trunc-toward-zero
//   start cell.  T x K floats and ints, a few KB;
// * the other threads write the s_values row meanwhile (block 0 also
//   t_values); after one barrier all threads mark the T x S cells, slice by
//   slice, each cell looping over that slice's active cars only: the
//   distance minimum from the 1e10 sentinel and the half-open band
//   [start - reach_cells, start + reach_cells).  Consecutive threads write
//   consecutive cells of the (B, T, S) outputs.  No (B, K, S) value reaches
//   device memory;
// * exactness: every float operation is the one the plain path performs on
//   the card, in its order ((step * dx) / safe, IEEE sqrtf and division,
//   clamps that pass a NaN through), built with -fmad=false so that no
//   multiply and add fuse.  Settings, geometry and the per-slice reach
//   arrive from the wrapper rounded once to f32, as PyTorch rounds a Python
//   scalar: slice 0's reach is a host double rounded once, the later
//   slices' an f32 add, as build_st_grid_plain computes them.
//
// K, T, S and the per-slice reach are runtime arguments; T is at most
// kMaxT and a block's lists must fit its default 48 KB of shared memory.
// obstacle_grid_check is the one place that holds those limits: the
// launcher refuses what it refuses, and the wrapper raises on it.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

// A named namespace, so that a profiler's trace shows the kernel as
// obstacle_grid_kernel and not as "(anonymous namespace)::...".
namespace obstacle_grid_impl {

constexpr int kThreads = 256;
constexpr int kMaxT = 64;

// Settings and geometry, each rounded once to f32 on the host; the order
// is the wrapper's _constants order.
struct Consts {
  float dt;                  // T_DISCRETIZATION (the forecast step)
  float ds;                  // S_DISCRETIZATION
  float car_length;          // CAR_LENGTH
  float min_obstacle_s;      // CRASH_MIN_S - MIN_ALLOWED_DISTANCE
  float max_decel;           // MAX_PREDICTED_DECELERATION
  float reaction_threshold;  // prediction.EGO_REACTION_THRESHOLD
  float reaction_gap;        // prediction.REACTION_GAP
  float merge_x, merge_y;    // geometry.MERGE_POINT
  float merge2_x, merge2_y;  // geometry.MERGE_POINT2
  float merge3_x;            // geometry.MERGE_POINT3[0]
  float common_s;            // geometry.COMMON_S
  float highway_y;           // geometry.HIGHWAY_Y
};

// Per-slice reach: in metres (the distance field's bumper offset) and in
// cells (the blocked band's half width).
struct Slices {
  float reach[kMaxT];
  int cells[kMaxT];
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}
__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}

// torch.clamp_min: a NaN passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// geometry.get_ego_s
__device__ __forceinline__ float ego_s(float x, float y, const Consts& c) {
  const float dx = x - c.merge_x;
  const float dy = y - c.merge_y;
  const float d = sqrtf(dx * dx + dy * dy);
  const float after = (x - c.merge2_x) + c.common_s;
  return x < c.merge_x ? -d : (x < c.merge2_x ? d : after);
}

// One predict_step_without_ego (prediction.py): the virtual ego's cases,
// then predict_step_with_ego's ego move and leader chain.  Updates the ego
// pose and the slots in place and lists slot k in `obs`/`cells` when it is
// active in the slice this step reaches.  Returns the list's length.
__device__ int roll_step(float& ex, float& ey, float* xs, float* vs,
                         const unsigned char* present, int num_k,
                         float start_s, float s_hi, float* obs, int* cells,
                         const Consts& c) {
  // --- predict_step_without_ego: the cases A, B, C1, C2
  const float es = ego_s(ex, ey, c);
  bool any_present = false;
  int first_behind = -1;
  int last_present = num_k - 1;
  for (int k = 0; k < num_k; ++k) {
    if (!present[k]) continue;
    any_present = true;
    last_present = k;
    if (first_behind < 0 && xs[k] < ex) first_behind = k;
  }
  const bool any_behind = first_behind >= 0;
  const bool front_most_behind = present[0] && xs[0] < ex;
  const int prev_idx = any_behind && first_behind > 0 ? first_behind - 1 : 0;
  const float prev_x = xs[prev_idx];
  const float prev_speed = vs[prev_idx];
  const float rear_speed = any_present ? vs[last_present] : 0.0f;
  const bool case_a = es < c.reaction_threshold || !any_present;
  const bool case_b = !case_a && front_most_behind;
  const bool case_c1 = !case_a && !case_b && any_behind;
  const float mx = case_b ? -20.0f
                   : (case_c1 ? (prev_x - c.car_length) - 5.0f : ex);
  const float my = case_b ? -10.0f : ey;
  const float sel = (case_a || case_b) ? 0.0f
                    : (case_c1 ? prev_speed : rear_speed);

  // --- predict_step_with_ego: _predict_ego_position
  const float dx = c.merge2_x - mx;
  const float dy = c.merge2_y - my;
  const float norm = sqrtf(dx * dx + dy * dy);
  const float step = sel * c.dt;
  const float safe = clamp_min(norm, 1e-12f);
  const float pre_x = mx + (step * dx) / safe;
  const float pre_y = clamp_min(my + (step * dy) / safe, c.highway_y);
  const float post_x = mx + sel * c.dt;
  const bool on_ramp = mx < c.merge2_x;
  const float px = on_ramp ? pre_x : post_x;
  const float py = on_ramp ? pre_y : my;
  const bool merged = ego_s(px, py, c) > c.reaction_threshold;

  // --- the leader chain, front to back in slot order
  int seen = 0;
  float last_x = pos_inf();
  float last_speed = 0.0f;
  int n = 0;
  for (int k = 0; k < num_k; ++k) {
    const float x = xs[k];
    const float speed = vs[k];
    const bool p = present[k] != 0;
    const bool behind = x < px;
    const bool use_ego = behind && seen == 0 && merged;
    if (behind && p) ++seen;
    const float lead_x = use_ego ? px : last_x;
    const float lead_speed = use_ego ? sel : last_speed;
    const float speed_diff = lead_speed - speed;
    const bool reacting = speed_diff < 0.0f && (lead_x - x) < c.reaction_gap;
    const float new_accel = reacting ? clamp_min(speed_diff, c.max_decel)
                                     : 0.0f;
    const float new_speed = reacting ? speed + new_accel * c.dt : speed;
    const float new_x = x + new_speed * c.dt;
    last_x = p ? new_x : lead_x;
    last_speed = p ? new_speed : lead_speed;
    xs[k] = p ? new_x : neg_inf();
    vs[k] = p ? new_speed : 0.0f;
    if (p) {
      const float o = new_x - c.merge3_x;
      if (o >= c.min_obstacle_s && o <= s_hi) {
        obs[n] = o;
        cells[n] = static_cast<int>((o - start_s) / c.ds);
        ++n;
      }
    }
  }
  ex = px;
  ey = py;
  return n;
}

__global__ void __launch_bounds__(kThreads) obstacle_grid_kernel(
    const float* __restrict__ ego_x, const float* __restrict__ ego_y,
    const float* __restrict__ other_x, const float* __restrict__ other_speed,
    const uint8_t* __restrict__ other_present, uint8_t* __restrict__ obstacles,
    float* __restrict__ distances, float* __restrict__ s_values,
    float* __restrict__ t_values, int num_k, int num_t, int num_s, Consts c,
    Slices sl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);      // K
  float* vs = xs + num_k;                               // K
  float* obs = vs + num_k;                              // T x K
  int* cells = reinterpret_cast<int*>(obs + num_t * num_k);  // T x K
  int* count = cells + num_t * num_k;                   // T
  unsigned char* present = reinterpret_cast<unsigned char*>(count + num_t);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float start_s = ego_s(ego_x[b], ego_y[b], c);

  if (tid == 0) {
    const size_t row = static_cast<size_t>(b) * num_k;
    for (int k = 0; k < num_k; ++k) {
      xs[k] = other_x[row + k];
      vs[k] = other_speed[row + k];
      present[k] = other_present[row + k] != 0;
    }
    // _mark_slice's active test: present, not behind the crash zone, not
    // past the horizon's last cell plus a car
    const float s_hi = (start_s + static_cast<float>(num_s - 1) * c.ds)
                       + c.car_length;
    int n = 0;
    for (int k = 0; k < num_k; ++k) {
      const float o = xs[k] - c.merge3_x;
      if (present[k] && o >= c.min_obstacle_s && o <= s_hi) {
        obs[n] = o;
        cells[n] = static_cast<int>((o - start_s) / c.ds);
        ++n;
      }
    }
    count[0] = n;
    float ex = ego_x[b];
    float ey = ego_y[b];
    for (int t = 1; t < num_t; ++t)
      count[t] = roll_step(ex, ey, xs, vs, present, num_k, start_s, s_hi,
                           obs + t * num_k, cells + t * num_k, c);
  } else {
    float* srow = s_values + static_cast<size_t>(b) * num_s;
    for (int j = tid - 1; j < num_s; j += kThreads - 1)
      srow[j] = start_s + static_cast<float>(j) * c.ds;
    if (b == 0)
      for (int t = tid - 1; t < num_t; t += kThreads - 1)
        t_values[t] = static_cast<float>(t) * c.dt;
  }
  __syncthreads();

  const size_t grid0 = static_cast<size_t>(b) * num_t * num_s;
  for (int t = 0; t < num_t; ++t) {
    const int n = count[t];
    const float reach = sl.reach[t];
    const int half = sl.cells[t];
    const float* o = obs + t * num_k;
    const int* start = cells + t * num_k;
    uint8_t* obst_row = obstacles + grid0 + static_cast<size_t>(t) * num_s;
    float* dist_row = distances + grid0 + static_cast<size_t>(t) * num_s;
    for (int j = tid; j < num_s; j += kThreads) {
      const float s = start_s + static_cast<float>(j) * c.ds;
      float dist = 1e10f;
      bool blocked = false;
      for (int i = 0; i < n; ++i) {
        const float y = fabsf(s - o[i]);
        dist = fminf(dist, fabsf(y - reach));
        const int off = j - start[i] + half;
        blocked |= off >= 0 && off < 2 * half;
      }
      obst_row[j] = blocked;
      dist_row[j] = blocked ? 0.0f : dist;
    }
  }
}

size_t smem_bytes(int num_t, int num_k) {
  const size_t k = static_cast<size_t>(num_k);
  const size_t t = static_cast<size_t>(num_t);
  return sizeof(float) * 2 * k + (sizeof(float) + sizeof(int)) * t * k
         + sizeof(int) * t + k;
}

}  // namespace obstacle_grid_impl

using obstacle_grid_impl::Consts;
using obstacle_grid_impl::Slices;
using obstacle_grid_impl::kMaxT;
using obstacle_grid_impl::kThreads;
using obstacle_grid_impl::obstacle_grid_kernel;
using obstacle_grid_impl::smem_bytes;

extern "C" {

int obstacle_grid_num_consts() {
  return static_cast<int>(sizeof(Consts) / sizeof(float));
}

// 0 when one launch takes a grid of this shape, else cudaErrorInvalidValue:
// 1 <= T <= kMaxT, K >= 1, and the block's lists within the default 48 KB
// of shared memory.
int obstacle_grid_check(int batch, int num_k, int num_t, int num_s) {
  if (batch < 1 || num_k < 1 || num_t < 1 || num_t > kMaxT || num_s < 1 ||
      smem_bytes(num_t, num_k) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// Launch on `stream`; allocates nothing.  ego_x, ego_y (B,), other_x,
// other_speed (B, K) f32 and other_present (B, K) one byte a slot, all
// contiguous; obstacles (B, T, S) one byte a cell, distances (B, T, S),
// s_values (B, S), t_values (T,) f32; consts as Consts, reach (T,) f32,
// reach_cells (T,) int.  Returns obstacle_grid_check's refusal, else the
// CUDA error code of the launch (0 on success).
int obstacle_grid_launch(const float* ego_x, const float* ego_y,
                         const float* other_x, const float* other_speed,
                         const void* other_present, void* obstacles,
                         float* distances, float* s_values, float* t_values,
                         int batch, int num_k, int num_t, int num_s,
                         const float* consts, const float* reach,
                         const int* reach_cells, void* stream) {
  const int refused = obstacle_grid_check(batch, num_k, num_t, num_s);
  if (refused != 0) return refused;
  Consts c;
  std::memcpy(&c, consts, sizeof(Consts));
  Slices sl;
  std::memset(&sl, 0, sizeof(Slices));
  std::memcpy(sl.reach, reach, sizeof(float) * num_t);
  std::memcpy(sl.cells, reach_cells, sizeof(int) * num_t);
  obstacle_grid_kernel<<<batch, kThreads, smem_bytes(num_t, num_k),
                         static_cast<cudaStream_t>(stream)>>>(
      ego_x, ego_y, other_x, other_speed,
      static_cast<const uint8_t*>(other_present),
      static_cast<uint8_t*>(obstacles), distances, s_values, t_values, num_k,
      num_t, num_s, c, sl);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
