// Direction winner + confirm for one tick of the simulation core.
//
// Replaces tarl_tpu/core/fused_winner.py::_kernel, the Pallas TPU kernel
// of direction_confirm_fused.  The TPU kernel evaluated the in-slot and
// out-slot gathers as lane rotations over a roll plan with an exception
// overlay, because TPU gathers are slow.  Here they are direct gathers, so
// no roll plan is needed at any network size.
//
// Two launches on the caller's stream:
//   1. fw_winner_kernel, one thread per downstream road v: for each in-slot
//      k it reads the upstream u = in_src[k, v] and u's head (departure,
//      id, dest) straight from the ring, fifo[u, head[u]] (0 when
//      count[u] == 0), applies the eligibility of core/direction.py, and
//      keeps the Gumbel-max winner over in_logit + gumbel (ascending slot,
//      strict >).  The sentinel agent 0 never wins.
//   2. fw_confirm_kernel, one thread per road u: u pops iff some out-slot
//      k has out_ok[k, u] and win_src[out_dst[k, u]] == u.
//
// Arithmetic is float32 adds, subtracts and compares only, compiled
// without fast math, so results are bitwise those of the PyTorch plain
// version (tarl_tpu_torch/core/fused_winner.py::direction_confirm_plain).
//
// Bound: memory latency.  Each road makes about KIN * 5 dependent gathers
// (in_src, then u's count, head, selection, capacity, and the ring row)
// on an [R]-sized working set that sits in L2: 960 roads x 28 slots at the
// headline Grid16x16, 16,128 roads at Grid64x64.  This simple form does
// nothing about that bound yet: one thread per road, no shared memory, no
// overlap of the two launches.
//
// A third kernel, fw_shard_winner_kernel (entry tarl_fused_shard_winner),
// replaces tarl_tpu/core/fused_winner.py::_shard_winner_kernel, the Pallas
// TPU kernel of fused_shard_winner: the winner alone (no confirm) on the
// road blocks of a road-sharded tick.  The TPU kernel took the in-slot
// reads pre-rotated through the roll plan, one launch per shard; here one
// thread per local road covers every block of the device in one launch
// and gathers the upstream packed word (flags, integral free space,
// selection) from the replicated [Rp] halo vector, and the head id and
// dest of the winner only.  Local road v is global road col0 + v.  Bound
// like the winner kernel above: each road reads its count, capacity and
// each slot's valid flag; a valid slot its source and the source's packed
// word (one dependent gather from a vector that sits in L2); an eligible
// slot its logit and noise; a winning road its winner's head id and dest.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

__global__ void fw_winner_kernel(
    const int* __restrict__ fifo_ids, const float* __restrict__ fifo_dep,
    const int* __restrict__ fifo_dest, const int* __restrict__ head,
    const int* __restrict__ count, const int* __restrict__ sel,
    const float* __restrict__ cap, const int* __restrict__ in_src,
    const float* __restrict__ in_logit, const unsigned char* __restrict__ in_ok,
    const float* __restrict__ gumbel, float time_arg,
    const float* __restrict__ time_dev, float patience,
    float buffer, float free_mask, int R, int nmax, int kin,
    unsigned char* __restrict__ accept, int* __restrict__ win_src,
    int* __restrict__ agent_out, int* __restrict__ dest_out) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= R) return;
  // The clock: a host value, or a device scalar (the RL environment's
  // event-time clock, which the host never reads).
  const float time = time_dev ? *time_dev : time_arg;
  const float count_v = static_cast<float>(count[v]);
  const float cap_v = cap[v];
  const bool space_ok = count_v < cap_v - buffer;
  const float v_free = cap_v - count_v;
  const bool v_has_slot = count_v < cap_v;

  float best = -CUDART_INF_F;
  bool acc = false;
  int src = 0, agent = 0, dest = 0;
  for (int k = 0; k < kin; ++k) {
    const int idx = k * R + v;
    if (!in_ok[idx]) continue;            // padding slot: score -inf
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
    // Integral free space, as the reference's packed upstream word holds it.
    float u_free = fminf(fmaxf(cap[u] - static_cast<float>(cnt_u), 0.0f),
                         free_mask);
    u_free = static_cast<float>(static_cast<int>(u_free));
    const bool u_full = u_free <= buffer;
    bool mask = dep_ok && space_ok && wants_v && nonempty;
    mask = mask || (stuck && u_full && (u_free <= v_free) && wants_v &&
                    nonempty && v_has_slot);
    if (!mask) continue;
    const float s = in_logit[idx] + gumbel[idx];
    if (s > best) {
      best = s;
      acc = true;
      src = u;
      agent = fifo_ids[cell];
      dest = fifo_dest[cell];
    }
  }
  if (!acc) agent = 0;
  acc = agent != 0;                       // sentinel guard
  accept[v] = acc ? 1 : 0;
  win_src[v] = acc ? src : R;
  agent_out[v] = agent;
  dest_out[v] = acc ? dest : 0;
}

__global__ void fw_confirm_kernel(
    const int* __restrict__ win_src, const int* __restrict__ out_dst,
    const unsigned char* __restrict__ out_ok, int R, int kout,
    unsigned char* __restrict__ popped) {
  int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= R) return;
  bool p = false;
  for (int k = 0; k < kout; ++k) {
    const int idx = k * R + u;
    p = p || (out_ok[idx] && win_src[out_dst[idx]] == u);
  }
  popped[u] = p ? 1 : 0;
}

__global__ void fw_shard_winner_kernel(
    const int* __restrict__ pack, const int* __restrict__ head_id,
    const int* __restrict__ head_dest, const float* __restrict__ gumbel,
    const float* __restrict__ logit, const int* __restrict__ src,
    const unsigned char* __restrict__ ok, const float* __restrict__ count_f,
    const float* __restrict__ cap, int col0, int r_sentinel, int shift_free,
    int shift_sel, int free_mask, float buffer, int n, int kin,
    unsigned char* __restrict__ accept, int* __restrict__ win,
    int* __restrict__ agent_out, int* __restrict__ dest_out) {
  int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  const float count_v = count_f[v];
  const float cap_v = cap[v];
  const bool space_ok = count_v < cap_v - buffer;
  const float v_free = cap_v - count_v;
  const bool v_slot_ok = count_v < cap_v;
  const int col = col0 + v;

  float best = -CUDART_INF_F;
  bool acc = false;
  int src_w = 0;
  for (int k = 0; k < kin; ++k) {
    const long long idx = static_cast<long long>(k) * n + v;
    if (!ok[idx]) continue;               // padding slot: score -inf
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
    const float s = logit[idx] + gumbel[idx];
    if (s > best) {
      best = s;
      acc = true;
      src_w = u;
    }
  }
  const int agent = acc ? head_id[src_w] : 0;
  acc = agent != 0;                       // sentinel guard
  accept[v] = acc ? 1 : 0;
  win[v] = acc ? src_w : r_sentinel;
  agent_out[v] = agent;
  dest_out[v] = acc ? head_dest[src_w] : 0;
}

}  // namespace

extern "C" int tarl_fused_winner(
    const int* fifo_ids, const float* fifo_dep, const int* fifo_dest,
    const int* head, const int* count, const int* sel, const float* cap,
    const int* in_src, const float* in_logit, const unsigned char* in_ok,
    const int* out_dst, const unsigned char* out_ok, const float* gumbel,
    float time, const float* time_dev, float patience, float buffer,
    float free_mask, int R,
    int nmax, int kin, int kout, unsigned char* accept, int* win_src,
    int* agent, int* dest, unsigned char* popped, void* stream) {
  const int threads = 256;
  const int blocks = (R + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fw_winner_kernel<<<blocks, threads, 0, s>>>(
      fifo_ids, fifo_dep, fifo_dest, head, count, sel, cap, in_src, in_logit,
      in_ok, gumbel, time, time_dev, patience, buffer, free_mask, R, nmax,
      kin, accept,
      win_src, agent, dest);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fw_confirm_kernel<<<blocks, threads, 0, s>>>(win_src, out_dst, out_ok, R,
                                               kout, popped);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tarl_fused_shard_winner(
    const int* pack, const int* head_id, const int* head_dest,
    const float* gumbel, const float* logit, const int* src,
    const unsigned char* ok, const float* count_f, const float* cap,
    int col0, int r_sentinel, int shift_free, int shift_sel, int free_mask,
    float buffer, int n, int kin, unsigned char* accept, int* win,
    int* agent, int* dest, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  fw_shard_winner_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      pack, head_id, head_dest, gumbel, logit, src, ok, count_f, cap, col0,
      r_sentinel, shift_free, shift_sel, free_mask, buffer, n, kin, accept,
      win, agent, dest);
  return static_cast<int>(cudaGetLastError());
}
