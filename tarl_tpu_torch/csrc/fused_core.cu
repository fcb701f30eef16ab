// Per-segment Gumbel-max with two payloads, its noise drawn in the kernel:
// the sampler of the fused edge-phase core, with or without the core's
// eligibility pass in the same launch.
//
// Replaces tarl_tpu/core/fused_core.py::_argmax_payload_kernel (K12), the
// Pallas TPU kernel of gumbel_argmax_payload.  The TPU kernel streamed the
// turn-edge list through VMEM in tiles of 512, seeded the TPU's hardware
// generator per tile, and reduced each tile against a one-hot [tile,
// segments] block on the vector unit, carrying the best score and the two
// payloads (as float32) across the sequential grid.  Its caller,
// fused_core_step, computed the eligibility, the gridlock escape and the
// logits over the edge list in XLA first, about 40 elementwise and gather
// ops.
//
// Two entries share one body, fc_kernel<kFused>:
//   tarl_gumbel_argmax_payload (kFused = false) takes the logits and the
//     two payload rows: the TPU kernel's function;
//   tarl_fused_core_sample (kFused = true) takes the road state at the
//     heads and the network's edge tables, and computes each edge's logit
//     itself, exactly as tarl_tpu/core/fused_core.py::fused_core_step does
//     in float32 (dep_ok, space_ok, wants_v, nonempty, the gridlock escape
//     with its guards; prob = edge_attr * mask; logit = log(max(prob,
//     1e-30)) where prob > 0, else -inf).  Its payloads are the upstream's
//     head agent and the upstream itself.  The edge phase of a tick is one
//     launch.
//
// Layout: each segment (a downstream road) takes a group of G lanes, G the
// next power of two at or above its longest run (at most 32: past 32, lane
// l walks the run's elements l, l + 32, ...), over a CSR of the segment
// ids (tarl_tpu_torch/ops/segment.py::SegmentLayout, built once per
// network), whose runs hold ascending edge indices.  Each lane scans its
// elements in order with a strict >, and the group reduces (score, edge)
// with __shfl_xor_sync, the lower edge winning a tie: the sequential scan's
// first maximum, as in the TPU kernel.  No atomics, no shared memory.
//
// Noise: the TPU's hardware bits exist on no other machine, so edge e takes
// threefry_bits(key, e) (threefry.cuh; jax.random.bits(key, (E,))[e]) and
// the TPU kernel's own transform, u = (bits >> 8) * 2^-24 and
// g = -log(-log(u + 1e-7) + 1e-7), in float32.  Only edges with a finite
// logit above NEG_LARGE draw it; others cannot win.
//
// Semantics (held bitwise against the plain PyTorch versions,
// tarl_tpu_torch/core/fused_core.py::gumbel_argmax_payload_plain and
// fused_core_sample_plain):
//   score(e) = logit(e) + g(e) where logit(e) is finite and > NEG_LARGE;
//   the winner of a segment is its first element of largest score above
//   NEG_LARGE; out_a / out_b are its payloads (int32, not float32: exact at
//   any size); a segment without one gives a = 0 and b = num_segments.
// Compiled without fast math and with --fmad=false: logf is the precise
// library function, the one PyTorch's float32 log calls on the card.
//
// Bound: bytes.  The fused entry reads, for each edge, its source, weight
// and CSR order, and the source's count, selection, capacity, head slot
// and head departure; each segment's count, capacity and offsets; the
// winner's head agent; and writes 8 bytes a segment: ~150 KB at the
// headline Grid16x16 (E = 3,656, R = 960), ~45 ns at 3.35 TB/s, with one
// threefry block (~130 operations) per eligible edge.  So the launch is the
// cost at the main path's size; what the fused entry removes is the ~40
// launches of the eligibility pass around it.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr float kNegLarge = -3.4e38f;

// What the fused entry reads of the roads and the turn edges.
struct CoreView {
  const int* fifo_ids;
  const float* fifo_dep;
  const int* head;
  const int* count;
  const int* sel;
  const float* cap;
  const int* edge_src;
  const float* edge_attr;
  float time, patience, buffer;
  int nmax;
};

// What the bare entry reads: the logits and the two payload rows.
struct EdgeView {
  const float* logits;
  const int* pay_a;
  const int* pay_b;
};

// The logit of edge e into road v, as fused_core_step computes it.
__device__ __forceinline__ float edge_logit(const CoreView& c, int e, int v,
                                            float cnt_v, float cap_v) {
  const int u = c.edge_src[e];
  const int cnt_ui = c.count[u];
  const bool nonempty = cnt_ui > 0;
  const float hd = nonempty
      ? c.fifo_dep[static_cast<long long>(u) * c.nmax + c.head[u]] : 0.0f;
  const float cnt_u = static_cast<float>(cnt_ui);
  const float cap_u = c.cap[u];
  const bool wants_v = c.sel[u] == v;
  bool mask = (hd <= c.time) && (cnt_v < cap_v - c.buffer) && wants_v &&
              nonempty;
  const bool stuck = (hd - c.time) < -c.patience;
  const bool u_full = cap_u - c.buffer <= cnt_u;
  const bool v_freer = cap_u - cnt_u <= cap_v - cnt_v;
  const bool v_has_slot = cnt_v < cap_v;
  mask = mask || (stuck && u_full && v_freer && wants_v && nonempty &&
                  v_has_slot);
  const float prob = c.edge_attr[e] * (mask ? 1.0f : 0.0f);
  return prob > 0.0f ? logf(fmaxf(prob, 1e-30f)) : -CUDART_INF_F;
}

template <bool kFused>
__global__ void fc_kernel(CoreView core, EdgeView edges,
                          const int* __restrict__ order,
                          const int* __restrict__ offsets, int n, int group,
                          uint32_t k1, uint32_t k2, int* __restrict__ out_a,
                          int* __restrict__ out_b) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = gid / group;
  const int lane = gid & (group - 1);
  const bool live = s < n;

  // This lane's best element: score and edge (INT_MAX for none).  Lanes
  // past the last segment hold none but join the shuffles.
  float best = kNegLarge;
  int best_e = INT_MAX;
  if (live) {
    float cnt_v = 0.0f, cap_v = 0.0f;
    if (kFused) {
      cnt_v = static_cast<float>(core.count[s]);
      cap_v = core.cap[s];
    }
    const int end = offsets[s + 1];
    for (int j = offsets[s] + lane; j < end; j += group) {
      const int e = order[j];
      const float logit = kFused ? edge_logit(core, e, s, cnt_v, cap_v)
                                 : edges.logits[e];
      if (!(isfinite(logit) && logit > kNegLarge)) continue;
      const uint32_t bits =
          tarl::threefry_bits(k1, k2, static_cast<uint64_t>(e));
      const float u = static_cast<float>(static_cast<int>(bits >> 8)) *
                      (1.0f / 16777216.0f);
      const float g = -logf(-logf(u + 1e-7f) + 1e-7f);
      const float score = logit + g;
      if (score > best) {
        best = score;
        best_e = e;
      }
    }
  }
  // The group's winner: the larger score, the lower edge on a tie.
  float top = best;
  int top_e = best_e;
  for (int off = group >> 1; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, top, off);
    const int o_e = __shfl_xor_sync(0xffffffffu, top_e, off);
    if (o > top || (o == top && o_e < top_e)) {
      top = o;
      top_e = o_e;
    }
  }
  if (!live) return;
  // The lane that holds the winner writes; lane 0 where none won.
  const bool none = top_e == INT_MAX;
  if (none ? lane != 0 : best_e != top_e) return;
  int a = 0, b = n;
  if (!none) {
    if (kFused) {
      const int u = core.edge_src[top_e];
      a = core.fifo_ids[static_cast<long long>(u) * core.nmax + core.head[u]];
      b = u;
    } else {
      a = edges.pay_a[top_e];
      b = edges.pay_b[top_e];
    }
  }
  out_a[s] = a;
  out_b[s] = b;
}

template <bool kFused>
int launch(const CoreView& core, const EdgeView& edges, const int* order,
           const int* offsets, int n, int width, uint32_t k1, uint32_t k2,
           int* out, void* stream) {
  if (n == 0) return 0;
  int group = 1;
  while (group < width && group < 32) group <<= 1;
  const int threads = 128;
  const long long lanes = static_cast<long long>(n) * group;
  const int blocks = static_cast<int>((lanes + threads - 1) / threads);
  fc_kernel<kFused><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      core, edges, order, offsets, n, group, k1, k2, out, out + n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out holds a and b, n each.  width sets the lanes per segment (its
// longest run, or any estimate: past the group's size the lanes walk).
extern "C" int tarl_gumbel_argmax_payload(const float* logits,
                                          const int* pay_a, const int* pay_b,
                                          const int* order, const int* offsets,
                                          int n, int width, uint32_t k1,
                                          uint32_t k2, int* out,
                                          void* stream) {
  const CoreView core{};
  const EdgeView edges{logits, pay_a, pay_b};
  return launch<false>(core, edges, order, offsets, n, width, k1, k2, out,
                       stream);
}

// out holds the head agent and the source road of each road's winner, R
// each.
extern "C" int tarl_fused_core_sample(
    const int* fifo_ids, const float* fifo_dep, const int* head,
    const int* count, const int* sel, const float* cap, const int* edge_src,
    const float* edge_attr, const int* order, const int* offsets,
    float time, float patience, float buffer, int R, int nmax, int kin,
    uint32_t k1, uint32_t k2, int* out, void* stream) {
  const CoreView core{fifo_ids, fifo_dep, head,      count,
                      sel,      cap,      edge_src,  edge_attr,
                      time,     patience, buffer,    nmax};
  const EdgeView edges{};
  return launch<true>(core, edges, order, offsets, R, kin, k1, k2, out,
                      stream);
}
