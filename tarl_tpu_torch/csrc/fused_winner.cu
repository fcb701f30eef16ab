// Direction winner + confirm for one tick of the simulation core, the
// Gumbel noise drawn in the kernel, in one launch.
//
// Replaces tarl_tpu/core/fused_winner.py::_kernel, the Pallas TPU kernel
// of direction_confirm_fused.  The TPU kernel evaluated the in-slot and
// out-slot gathers as lane rotations over a roll plan with an exception
// overlay, because TPU gathers are slow, and took the [KIN, R] Gumbel
// matrix that its wrapper drew from the tick's key.  Here the gathers are
// direct, so no roll plan is needed at any network size, and the noise is
// drawn where it is used: no matrix in device memory, no draw before the
// launch.
//
// fw_winner_kernel gives each downstream road v a group of G lanes, G the
// next power of two at or above KIN (at most 32: past 32 lane l walks the
// slots l, l + 32, ...).  Lane k takes in-slot k: it reads the upstream
// u = in_src[k, v], then u's count, head, selection and capacity, then
// u's head departure from the ring, fifo[u, head[u]] (0 when count[u] is
// 0), and applies the eligibility of core/direction.py.  An eligible slot
// draws its noise and scores in_logit + g.  The group reduces (score,
// slot) with __shfl_xor_sync: the larger score wins and the lower slot
// wins a tie, which is the sequential strict-> scan over ascending slots.
// The lane holding the winner reads its id and dest, applies the sentinel
// guard (agent 0 never wins), writes v's four outputs and sets
// popped[u] = 1.  That scatter is the confirm: each upstream proposes to
// its single selected road, so it wins at most once, and the C entry
// zeroes popped (cudaMemsetAsync) before the launch.  The TPU kernel's
// confirm over the out-slot table, and this file's former second launch,
// compute the same mask.
//
// Noise: in-slot k of road v draws threefry_bits(key, k*R + road_order[v])
// (threefry.cuh), the canonical address of core/rng.py::direction_gumbel,
// and jax.random.gumbel's transform op for op (threefry.cuh::
// gumbel_from_bits, shared with K7 and K11).  Only eligible slots draw:
// the others cannot win.
//
// Arithmetic is float32 adds, multiplies, compares and logf, compiled
// without fast math and with --fmad=false, so results are bitwise those of
// the PyTorch plain version (tarl_tpu_torch/core/fused_winner.py::
// direction_confirm_plain) on the card.
//
// Bound: bytes.  The function reads each road's count and capacity and
// each slot's valid flag; each valid slot's source, and each distinct
// source's head, selection and ring departure once; each eligible slot's
// logit and its road's canonical position; the winner's id and dest; and
// writes five outputs of R: ~50 KB at the headline Grid16x16 (960 roads,
// 3,656 valid of 3,840 slots), ~0.015 us at 3.35 TB/s.  The integer work
// of one threefry block (~130 operations) per eligible slot takes less.
// So the launch is the cost at the main paths' sizes.  What the design
// cuts is latency and launches: a thread waits on one slot's chain of
// dependent loads instead of KIN chains in sequence (30 blocks of 128
// threads at R = 960 instead of 4 blocks of 256), and a tick makes one
// launch and a memset instead of two launches after a ~190-launch draw.
// Measured with scripts/time_k1_k9.py on an NVIDIA H100 80GB HBM3
// (700 W): 4.3 us of device time per call at R = 960 and 5.1 us at
// R = 16,128, kernel and memset, noise included, against 8.0 and 8.7 us
// for the two-launch form without its noise, whose draw took ~255 us of
// device time in 191 launches more.
//
// A second kernel, fw_shard_winner_kernel (entry tarl_fused_shard_winner),
// replaces tarl_tpu/core/fused_winner.py::_shard_winner_kernel, the Pallas
// TPU kernel of fused_shard_winner: the winner alone (no confirm) on the
// road blocks of a road-sharded tick.  The TPU kernel took the in-slot
// reads pre-rotated through the roll plan, one launch per shard, and the
// block's columns of the tick's [KIN, R] Gumbel matrix; here one launch
// covers every block of the device, in fw_winner_kernel's layout: each
// local road v (global column c = col0 + v) takes a group of lanes, a lane
// per in-slot, and the group reduces (score, slot) with __shfl_xor_sync,
// the lower slot winning a tie.  A lane gathers its upstream's packed word
// (flags, integral free space, selection) from the replicated [Rp] halo
// vector, and an eligible slot draws its own noise at the canonical
// address k*R + road_order[c] through gumbel_from_bits, as fw_winner_kernel
// does: no noise matrix is drawn, padded or read.  Padded columns (c >= R)
// have no slot.  The winning lane reads its upstream's head id and dest.
// Bound like the winner kernel above: each road reads its count, capacity
// and each slot's valid flag; a valid slot its source and the source's
// packed word (one dependent gather from a vector that sits in L2); an
// eligible slot its logit and its column's road_order entry and does one
// threefry block; a winning road reads its winner's head id and dest.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

__global__ void fw_winner_kernel(
    const int* __restrict__ fifo_ids, const float* __restrict__ fifo_dep,
    const int* __restrict__ fifo_dest, const int* __restrict__ head,
    const int* __restrict__ count, const int* __restrict__ sel,
    const float* __restrict__ cap, const int* __restrict__ in_src,
    const float* __restrict__ in_logit, const unsigned char* __restrict__ in_ok,
    const int* __restrict__ road_order, uint32_t k1, uint32_t k2,
    float time_arg, const float* __restrict__ time_dev, float patience,
    float buffer, float free_mask, int R, int nmax, int kin, int group,
    int* __restrict__ win_src, int* __restrict__ agent_out,
    int* __restrict__ dest_out, unsigned char* __restrict__ accept,
    unsigned char* __restrict__ popped) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = gid / group;
  const int lane = gid & (group - 1);
  const bool live = v < R;

  // This lane's best slot: score, slot (INT_MAX for none), upstream and
  // ring cell.  Lanes past the last road hold none but join the shuffles.
  float best = -CUDART_INF_F;
  int best_k = INT_MAX, best_u = 0;
  long long best_cell = 0;
  if (live) {
    // The clock: a host value, or a device scalar (the RL environment's
    // event-time clock, which the host never reads).
    const float time = time_dev ? *time_dev : time_arg;
    const float count_v = static_cast<float>(count[v]);
    const float cap_v = cap[v];
    const bool space_ok = count_v < cap_v - buffer;
    const float v_free = cap_v - count_v;
    const bool v_has_slot = count_v < cap_v;
    for (int k = lane; k < kin; k += group) {
      const int idx = k * R + v;
      if (!in_ok[idx]) continue;          // padding slot: score -inf
      const int u = in_src[idx];
      const int cnt_u = count[u];
      const bool nonempty = cnt_u > 0;
      const long long cell = static_cast<long long>(u) * nmax + head[u];
      const float hd = nonempty ? fifo_dep[cell] : 0.0f;
      const int su = sel[u];
      const int sel_enc = (su >= 0 && su < R) ? su : R;
      const bool wants_v = sel_enc == v;
      const bool dep_ok = hd <= time;
      const bool stuck = (hd - time) < -patience;
      // Integral free space, as the reference's packed upstream word
      // holds it.
      float u_free = fminf(fmaxf(cap[u] - static_cast<float>(cnt_u), 0.0f),
                           free_mask);
      u_free = static_cast<float>(static_cast<int>(u_free));
      const bool u_full = u_free <= buffer;
      bool mask = dep_ok && space_ok && wants_v && nonempty;
      mask = mask || (stuck && u_full && (u_free <= v_free) && wants_v &&
                      nonempty && v_has_slot);
      if (!mask) continue;
      const uint64_t q = static_cast<uint64_t>(k) * static_cast<uint64_t>(R)
                         + static_cast<uint64_t>(road_order[v]);
      const float s = in_logit[idx] +
                      tarl::gumbel_from_bits(tarl::threefry_bits(k1, k2, q));
      if (s > best) {
        best = s;
        best_k = k;
        best_u = u;
        best_cell = cell;
      }
    }
  }
  // The group's winner: the larger score, the lower slot on a tie.  Every
  // lane ends with the same (score, slot).
  float win = best;
  int win_k = best_k;
  for (int off = group >> 1; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, win, off);
    const int o_k = __shfl_xor_sync(0xffffffffu, win_k, off);
    if (o > win || (o == win && o_k < win_k)) {
      win = o;
      win_k = o_k;
    }
  }
  if (!live) return;
  // The lane that holds the winner writes; lane 0 where no slot won.
  const bool none = win_k == INT_MAX;
  if (none ? lane != 0 : (win_k & (group - 1)) != lane) return;
  const int agent = none ? 0 : fifo_ids[best_cell];
  const bool acc = agent != 0;            // sentinel guard
  accept[v] = acc ? 1 : 0;
  win_src[v] = acc ? best_u : R;
  agent_out[v] = agent;
  dest_out[v] = acc ? fifo_dest[best_cell] : 0;
  if (acc) popped[best_u] = 1;
}

__global__ void fw_shard_winner_kernel(
    const int* __restrict__ pack, const int* __restrict__ head_id,
    const int* __restrict__ head_dest, const float* __restrict__ logit,
    const int* __restrict__ src, const unsigned char* __restrict__ ok,
    const float* __restrict__ count_f, const float* __restrict__ cap,
    const int* __restrict__ road_order, uint32_t k1, uint32_t k2, int col0,
    int R, int r_sentinel, int shift_free, int shift_sel, int free_mask,
    float buffer, int n, int kin, int group,
    unsigned char* __restrict__ accept, int* __restrict__ win,
    int* __restrict__ agent_out, int* __restrict__ dest_out) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = gid / group;
  const int lane = gid & (group - 1);
  const bool live = v < n;
  const int col = col0 + v;

  // This lane's best slot: score, slot (INT_MAX for none) and upstream.
  // Lanes past the last road hold none but join the shuffles.
  float best = -CUDART_INF_F;
  int best_k = INT_MAX, best_u = 0;
  if (live && col < R) {                  // padded columns have no slot
    const float count_v = count_f[v];
    const float cap_v = cap[v];
    const bool space_ok = count_v < cap_v - buffer;
    const float v_free = cap_v - count_v;
    const bool v_slot_ok = count_v < cap_v;
    for (int k = lane; k < kin; k += group) {
      const long long idx = static_cast<long long>(k) * n + v;
      if (!ok[idx]) continue;             // padding slot: score -inf
      const int u = src[idx];
      const int p = pack[u];
      const bool dep_ok = (p & 1) != 0;
      const bool nonempty = (p & 2) != 0;
      const bool stuck = (p & 4) != 0;
      const float u_free = static_cast<float>((p >> shift_free) & free_mask);
      const bool wants_v = (p >> shift_sel) == col;
      bool mask = dep_ok && space_ok && wants_v && nonempty;
      mask = mask || (stuck && u_free <= buffer && u_free <= v_free &&
                      wants_v && nonempty && v_slot_ok);
      if (!mask) continue;
      const uint64_t q = static_cast<uint64_t>(k) * static_cast<uint64_t>(R)
                         + static_cast<uint64_t>(road_order[col]);
      const float s = logit[idx] +
                      tarl::gumbel_from_bits(tarl::threefry_bits(k1, k2, q));
      if (s > best) {
        best = s;
        best_k = k;
        best_u = u;
      }
    }
  }
  // The group's winner: the larger score, the lower slot on a tie.
  float top = best;
  int top_k = best_k;
  for (int off = group >> 1; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, top, off);
    const int o_k = __shfl_xor_sync(0xffffffffu, top_k, off);
    if (o > top || (o == top && o_k < top_k)) {
      top = o;
      top_k = o_k;
    }
  }
  if (!live) return;
  // The lane that holds the winner writes; lane 0 where no slot won.
  const bool none = top_k == INT_MAX;
  if (none ? lane != 0 : (top_k & (group - 1)) != lane) return;
  const int agent = none ? 0 : head_id[best_u];
  const bool acc = agent != 0;            // sentinel guard
  accept[v] = acc ? 1 : 0;
  win[v] = acc ? best_u : r_sentinel;
  agent_out[v] = agent;
  dest_out[v] = acc ? head_dest[best_u] : 0;
}

}  // namespace

extern "C" int tarl_fused_winner(
    const int* fifo_ids, const float* fifo_dep, const int* fifo_dest,
    const int* head, const int* count, const int* sel, const float* cap,
    const int* in_src, const float* in_logit, const unsigned char* in_ok,
    const int* road_order, uint32_t k1, uint32_t k2, float time,
    const float* time_dev, float patience, float buffer, float free_mask,
    int R, int nmax, int kin, int* ints, unsigned char* flags,
    void* stream) {
  // ints holds win_src, agent and dest, flags accept and popped, R each.
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* popped = flags + R;
  cudaError_t err = cudaMemsetAsync(popped, 0, R, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int group = 1;
  while (group < kin && group < 32) group <<= 1;
  const int threads = 128;
  const long long lanes = static_cast<long long>(R) * group;
  const int blocks = static_cast<int>((lanes + threads - 1) / threads);
  fw_winner_kernel<<<blocks, threads, 0, s>>>(
      fifo_ids, fifo_dep, fifo_dest, head, count, sel, cap, in_src, in_logit,
      in_ok, road_order, k1, k2, time, time_dev, patience, buffer, free_mask,
      R, nmax, kin, group, ints, ints + R, ints + 2 * R, flags, popped);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tarl_fused_shard_winner(
    const int* pack, const int* head_id, const int* head_dest,
    const float* logit, const int* src, const unsigned char* ok,
    const float* count_f, const float* cap, const int* road_order,
    uint32_t k1, uint32_t k2, int col0, int R, int r_sentinel,
    int shift_free, int shift_sel, int free_mask, float buffer, int n,
    int kin, unsigned char* accept, int* ints, void* stream) {
  // ints holds win, agent and dest, n each.
  if (n == 0) return 0;
  int group = 1;
  while (group < kin && group < 32) group <<= 1;
  const int threads = 128;
  const long long lanes = static_cast<long long>(n) * group;
  const int blocks = static_cast<int>((lanes + threads - 1) / threads);
  fw_shard_winner_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      pack, head_id, head_dest, logit, src, ok, count_f, cap, road_order, k1,
      k2, col0, R, r_sentinel, shift_free, shift_sel, free_mask, buffer, n,
      kin, group, accept, ints, ints + n, ints + 2 * n);
  return static_cast<int>(cudaGetLastError());
}
