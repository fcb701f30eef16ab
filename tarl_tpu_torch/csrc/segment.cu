// Segment sum, max and argmax over an edge list, one thread per segment;
// the learned policy's action (K11's fused entry) and the log-probability
// of an action or the log-softmax (K10's entry), each in one launch.
//
// Replaces the Pallas TPU kernels of tarl_tpu/ops/pallas_segment.py:
//   K9  _segment_sum_kernel    (segment_sum_pallas)
//   K10 _segment_max_kernel    (segment_max_pallas)
//   K11 _segment_argmax_kernel (segment_argmax_pallas)
// The TPU kernels streamed edge tiles through VMEM and reduced them with a
// one-hot contraction on the matrix unit (sum) or a masked max over a
// [tile, segments] block.  On the learned policy's path a segment is a
// node's out-edges (at most ~6 elements), so here each thread walks one
// segment's run of a CSR layout built once per id vector
// (tarl_tpu_torch/ops/segment.py::SegmentLayout): offsets[N + 1] and a
// stable element order[E] (ascending element index within a segment;
// out-of-range ids never enter a run).  No atomics, no shared memory.
//
// Semantics (those of the TPU kernels, held bitwise against the plain
// PyTorch versions in ops/segment.py):
//   sum:    float32 adds in ascending element order from 0.0f, compiled
//           with --fmad=false; equal to a sequential scatter-add.
//   max:    starts at NEG_LARGE (-3.4e38, the empty segment's value); a
//           NaN anywhere in the segment gives the canonical quiet NaN (the
//           Pallas kernel's jnp.maximum propagates NaN); otherwise a value
//           replaces the running max only when strictly greater, so of
//           -0.0 and +0.0 the first in element order stays.
//   argmax: a non-finite score counts as NEG_LARGE and only scores above
//           NEG_LARGE can win; strict > over ascending elements keeps the
//           lowest index among ties; a segment with no winner returns E.
//
// Bound: bytes.  The function reads data[E] and ids[E] (8 bytes an
// element) and writes N floats or ints: ~12 KB at Grid8x8 (E = 1,256,
// N = 352), ~4 ns at 3.35 TB/s.  At these shapes the launch is the whole
// cost, so the design spends nothing on bandwidth: one launch, one thread
// per segment, dependent loads of order[] then data[].  Shared memory, TMA
// or the tensor cores would have nothing to do at 12 KB.  Measured with
// scripts/time_k1_k9.py on an NVIDIA H100 80GB HBM3 (700 W): 2.1-2.2 us of
// device time per sum at Grid8x8, against 2.6 us for index_add_ and its
// zero fill, so the body costs nothing worth a change; what a call costs
// beyond that is the wrapper's host path (ops/segment.py), which checks
// the layout once where it is built and the data once per call.
//
// K11's second entry, tarl_segment_action (seg_action_kernel), is the
// learned policy's whole action in one launch: from the raw logits to the
// multi-hot bool[E] that GraphDistribution.mode() and .sample(key) return
// (tarl_tpu/rl/distribution.py:61-73), in place of a division, a Gumbel
// draw of ~180 small kernels (sample), the argmax, torch.zeros and a
// scatter.  Lane s walks segment s's run of the CSR twice:
//   1. x = logits[e] / temperature (an IEEE division, as torch's by a
//      tensor); only a finite x is a candidate.  With a key the score is
//      x + g[e], g[e] = jax.random.gumbel(key, (E,))[e] drawn here:
//      threefry_bits(key, e) and gumbel_from_bits (threefry.cuh), the
//      noise K1 and K7 draw.  Without one (mode) the score is x.  The
//      argmax is K11's: strict > in ascending element order from
//      NEG_LARGE, a non-finite score never wins.
//   2. hot[e] = (e == winner) over the run: a segment without a winner
//      writes false everywhere.
// Lanes past the last segment write false at the elements whose id is
// out of range, which the layout sorts past offsets[N].  So every element
// of the output is written by the kernel: no memset, no zero fill.  The
// result is the reference's hot.at[min(chosen, E)].set(True, mode="drop").
//
// A lane per segment and not a warp: on the policy's path a segment is
// one node's out-edges, at most ~6 at Grid8x8 and Grid16x16, so a warp
// would idle 26 of its lanes and pay a shuffle reduction for nothing; the
// threefry block per candidate (~130 integer operations) is the lane's
// only real work.  Bound: bytes, as the argmax above, plus one output
// byte an element; at Grid8x8 E = 1,256 with N = 352 ~12 KB, ~4 ns at
// 3.35 TB/s, and the draw's 1,256 x ~130 operations take ~2.4 ns at the
// float32 rate.  The launch is the cost: what the design removes is the
// kernels of mode() and sample() around the argmax.  Measured with
// scripts/time_k1_k9.py on an NVIDIA H100 80GB HBM3 (700 W) at Grid8x8:
// 2.59-2.68 us of device time for the mode and 3.55 us for the sample,
// noise included, each in one kernel, where the distribution's mode()
// took 15.3 us in 10 kernels and its sample() 270 us in 208.  TMA, shared
// memory and wgmma have nothing to do at these sizes.
//
// K10's log-prob entry, tarl_segment_log_prob (seg_log_prob_kernel), is
// what the rollout collection pays for the log-probability of its action
// (GraphDistribution.log_prob, tarl_tpu/rl/distribution.py:75-93), and,
// without an action, the distribution's log-softmax (log_probs), in one
// launch in place of ~28 small kernels (the scale, K10, K9 three times
// and the gathers, exp, clamp, log and masks between them).  Lane s walks
// segment s's run three times, the composition's arithmetic in its order:
//   1. x = logits[e] / temperature (an IEEE division, as
//      ops/segment.py::scale_logits); m = K10's max of the run (from
//      NEG_LARGE, strict >, NaN if the run holds one); the shift is m
//      where finite, else 0.
//   2. denom = sum of expf(x - shift) in ascending element order from
//      0.0f, K9's order; log_d = logf(denom < 1e-30f ? 1e-30f : denom):
//      torch.clamp(min=1e-30) keeps a NaN denominator NaN, where
//      fmaxf(NaN, 1e-30f) would give 1e-30f.
//   3. lp[e] = (x - shift) - log_d.  Without an action the kernel writes
//      lp.  With one it writes contrib[e] = action[e] ? lp[e] : 0.0f and
//      counts the run's hot elements c: the segment is valid when
//      (size > 0 ? c == 1 : c == 0); an invalid one stores 1 into the
//      flag, which the entry clears with a memset before the launch.
// The wrapper (ops/segment.py::segment_log_prob) sums contrib with
// torch.sum, as the plain composition sums its masked vector, and fills
// -inf where the flag is set (masked_fill_, whose scalar needs no device
// tensor: torch.where's would cost a fill kernel).  It refuses a layout
// that dropped an id, so every element lies in one run and is written:
// no zero fill.
//
// Bound: bytes.  The entry's function needs the logits, the order and
// the action read once (9 bytes an element), the offsets once, and one
// float32 written (contrib is the wrapper's intermediate, not counted):
// ~12.7 KB at Grid8x8 (E = 1,256, N = 352), ~3.8 ns at 3.35 TB/s; the
// log-softmax form writes 4 bytes an element, ~16.5 KB, ~4.9 ns.  The
// ~10 operations an element (the division, the compares, expf, logf, the
// subtractions) take ~0.2 ns at the float32 rate.  As for the other
// segment kernels the launch is the cost, so the design removes launches:
// one kernel and one memset where the composition ran ~34, and a
// lane per segment (runs of at most ~6 elements) rather than a warp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr float kNegLarge = -3.4e38f;

__global__ void seg_sum_kernel(const float* __restrict__ data,
                               const int* __restrict__ order,
                               const int* __restrict__ offsets, int n,
                               float* __restrict__ out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  float acc = 0.0f;
  for (int j = offsets[s]; j < offsets[s + 1]; ++j) acc += data[order[j]];
  out[s] = acc;
}

__global__ void seg_max_kernel(const float* __restrict__ data,
                               const int* __restrict__ order,
                               const int* __restrict__ offsets, int n,
                               float* __restrict__ out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  float acc = kNegLarge;
  bool nan = false;
  for (int j = offsets[s]; j < offsets[s + 1]; ++j) {
    const float v = data[order[j]];
    nan = nan || (v != v);
    acc = (v > acc) ? v : acc;
  }
  out[s] = nan ? __int_as_float(0x7fc00000) : acc;
}

__global__ void seg_argmax_kernel(const float* __restrict__ data,
                                  const int* __restrict__ order,
                                  const int* __restrict__ offsets, int n,
                                  int e_total, int* __restrict__ out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  float best = kNegLarge;
  int arg = e_total;
  for (int j = offsets[s]; j < offsets[s + 1]; ++j) {
    const int e = order[j];
    const float v = data[e];
    if (isfinite(v) && v > best) {
      best = v;
      arg = e;
    }
  }
  out[s] = arg;
}

__global__ void seg_action_kernel(const float* __restrict__ logits,
                                  const int* __restrict__ order,
                                  const int* __restrict__ offsets, int n,
                                  int e_total, float temperature, int draw,
                                  uint32_t k1, uint32_t k2,
                                  unsigned char* __restrict__ hot) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) {
    // Lane n + m writes the m-th dropped element (id out of range).
    const int j = offsets[n] + (t - n);
    if (j < e_total) hot[order[j]] = 0;
    return;
  }
  const int lo = offsets[t];
  const int hi = offsets[t + 1];
  float best = kNegLarge;
  int arg = -1;
  for (int j = lo; j < hi; ++j) {
    const int e = order[j];
    const float x = logits[e] / temperature;
    if (!isfinite(x)) continue;
    const float v =
        draw ? x + tarl::gumbel_from_bits(tarl::threefry_bits(
                       k1, k2, static_cast<uint64_t>(e)))
             : x;
    if (isfinite(v) && v > best) {
      best = v;
      arg = e;
    }
  }
  for (int j = lo; j < hi; ++j) {
    const int e = order[j];
    hot[e] = (e == arg) ? 1 : 0;
  }
}

__global__ void seg_log_prob_kernel(const float* __restrict__ logits,
                                    const int* __restrict__ order,
                                    const int* __restrict__ offsets, int n,
                                    float temperature,
                                    const unsigned char* __restrict__ action,
                                    float* __restrict__ out,
                                    unsigned char* __restrict__ invalid) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const int lo = offsets[s];
  const int hi = offsets[s + 1];
  float m = kNegLarge;
  bool nan = false;
  for (int j = lo; j < hi; ++j) {
    const float x = logits[order[j]] / temperature;
    nan = nan || (x != x);
    m = (x > m) ? x : m;
  }
  const float shift = (!nan && isfinite(m)) ? m : 0.0f;
  float denom = 0.0f;
  for (int j = lo; j < hi; ++j)
    denom += expf(logits[order[j]] / temperature - shift);
  const float log_d = logf(denom < 1e-30f ? 1e-30f : denom);
  int hot = 0;
  for (int j = lo; j < hi; ++j) {
    const int e = order[j];
    const float lp = (logits[e] / temperature - shift) - log_d;
    if (action == nullptr) {
      out[e] = lp;
    } else {
      const bool h = action[e] != 0;
      hot += h;
      out[e] = h ? lp : 0.0f;
    }
  }
  if (action != nullptr && (hi > lo ? hot != 1 : hot != 0)) *invalid = 1;
}

constexpr int kThreads = 128;

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int tarl_segment_sum(const float* data, const int* order,
                                const int* offsets, int n, float* out,
                                void* stream) {
  if (n == 0) return 0;
  seg_sum_kernel<<<blocks_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(data, order, offsets,
                                                        n, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tarl_segment_max(const float* data, const int* order,
                                const int* offsets, int n, float* out,
                                void* stream) {
  if (n == 0) return 0;
  seg_max_kernel<<<blocks_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(data, order, offsets,
                                                        n, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tarl_segment_argmax(const float* data, const int* order,
                                   const int* offsets, int n, int e_total,
                                   int* out, void* stream) {
  if (n == 0) return 0;
  seg_argmax_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      data, order, offsets, n, e_total, out);
  return static_cast<int>(cudaGetLastError());
}

// One lane per segment and one per element: lanes n.. cover the dropped
// elements past offsets[n].  draw = 0 is the mode (k1, k2 unread).
extern "C" int tarl_segment_action(const float* logits, const int* order,
                                   const int* offsets, int n, int e_total,
                                   float temperature, int draw, uint32_t k1,
                                   uint32_t k2, unsigned char* hot,
                                   void* stream) {
  if (n + e_total == 0) return 0;
  seg_action_kernel<<<blocks_for(n + e_total), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      logits, order, offsets, n, e_total, temperature, draw, k1, k2, hot);
  return static_cast<int>(cudaGetLastError());
}

// One lane per segment; the layout holds no dropped id (the wrapper
// refuses one), so the runs cover every element.  action == nullptr is
// the log-softmax (invalid unread); else the flag is cleared here and set
// by an invalid segment.
extern "C" int tarl_segment_log_prob(const float* logits, const int* order,
                                     const int* offsets, int n,
                                     float temperature,
                                     const unsigned char* action, float* out,
                                     unsigned char* invalid, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (action != nullptr) {
    const cudaError_t err = cudaMemsetAsync(invalid, 0, 1, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n == 0) return 0;
  seg_log_prob_kernel<<<blocks_for(n), kThreads, 0, st>>>(
      logits, order, offsets, n, temperature, action, out, invalid);
  return static_cast<int>(cudaGetLastError());
}
