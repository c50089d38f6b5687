// Causal / full GQA flash-attention backward for Hopper (sm_90a), bf16:
// the dQ sweep and the dK/dV sweep.
//
// Replaces edl_tpu/ops/flash_attention.py::_bwd_dq_kernel (pallas_call in
// _flash_bwd, entry flash_bwd_dq_bf16) and ::_bwd_dkv_kernel (entry
// flash_bwd_dkv_bf16). Both recompute the softmax from the forward's
// base-2 logsumexp (flash_fwd.cu, kWithLse) and take
// delta = rowsum(dO * O), which the wrapper computes in f32 beforehand
// as _flash_bwd does in XLA. Per (query row i, key j), as the TPU
// kernels:
//   p   = exp2((q_i . k_j) * sm_scale * log2(e) - lse_i)   f32
//         then masked to 0 (causal j > i, and the ragged T edge) --
//         the mask applies AFTER the exp2, as in the reference
//   dp  = dO_i . v_j                                         f32
//   ds  = p * (dp - delta_i) * sm_scale     (plain sm_scale: d/ds of s)
//   dq_i += bf16(ds) . k_j                  f32 accumulation, bf16 out
//   dv_j += bf16(p)^T . dO_i                f32 accumulation
//   dk_j += bf16(ds)^T . q_i                f32 accumulation
// exp2 is the one-op ex2.approx.ftz and p = exp2(fma(s, c, -lse)), as in
// the forward; both are far inside the tolerance the card tests hold the
// kernels to. Key tiles wholly above the causal diagonal are never
// loaded. GQA: the dK/dV item owns one KV head and sums over its H / KV
// query heads in f32 registers (the reference sums per-query-head dk/dv
// in XLA after its kernel): no per-head buffer, no atomics, dk/dv
// rounded to bf16 once. Both kernels are deterministic.
//
// Bound on an H100 SXM: the larger of FLOPs / 989 TF/s and bytes /
// 3.35 TB/s. dQ needs three products per live (row, key) pair (S, dP,
// dS.K: 6*d FLOPs), dK/dV four (S, dP, P^T.dO, dS^T.Q: 8*d); both read
// q, k, v, dO, lse, delta once and write their gradient once. At d = 128
// and T >= 128 both are bound by operations, so the design keeps the
// tensor cores fed, in the forward's shape (flash_fwd.cu):
//   * persistent: one CTA of 3 warpgroups an SM walks over work items of
//     128 rows, numbered heaviest causal item first and dealt back and
//     forth over the CTAs (item_index, flash_common.cuh);
//   * warpgroup 0 is the producer (setmaxnreg 40); thread 0 issues every
//     TMA load: the item's own 128-row tiles once, and the streamed tiles
//     into a 2-stage ring, one full/empty mbarrier pair a stage;
//   * warpgroups 1-2 are consumers, 64 rows of the item each (wgmma's M,
//     setmaxnreg 232). The two score products of a ring tile are wgmma
//     with both operands K-major in shared memory; p and ds are
//     formed on the accumulators and re-packed in registers as the bf16 A
//     operand of the gradient products (wgmma with A from registers),
//     whose B is the ring tile read MN-major through the transpose bit:
//     the same swizzled tile is the K-major operand of one product and
//     the MN-major operand of the next, so nothing is copied transposed.
//     A stage is released only after wgmma.wait_group has retired every
//     product that reads it. The two warpgroups take turns to issue
//     (ping-pong on named barriers 3 and 4), so one's exponentials run
//     under the other's products;
//   * rows past T arrive as zeros from TMA. The kernels still mask p
//     themselves (a zero query row against a zero lse gives p = 1, not
//     0). Each gradient leaves through shared memory in one TMA store a
//     64-row box, which drops rows >= T.
//   dK/dV (item: 128 keys of one (b, KV head); consumer: 64 keys). K and V
//     load once an item; the ring carries Q_i and dO_i (64 query rows)
//     over the group's query heads and, from the causal diagonal on,
//     their query tiles. S^T = K . Q_i^T and dP^T = V . dO_i^T put the
//     keys on the accumulator rows, so lse and delta are read by column
//     from the stage's shared memory. They cannot come by TMA at every T
//     (the compact [B*H, T] f32 rows are not 16-byte aligned when T % 4
//     != 0, e.g. T = 100), so warp 1 of the producer warpgroup loads them
//     with plain loads into the stage and counts as 32 arrivals on its
//     full barrier. S^T and dP^T are m64n64k16; dV += P^T . dO_i and
//     dK += dS^T . Q_i. Registers a consumer thread: dk 64 + dv 64 +
//     S^T 32 + dP^T 32 + 32 packed, so the ring tile stays 64 queries.
//     Shared memory at d = 128: K 32 KB + V 32 KB + 2 stages x (Q 16 KB +
//     dO 16 KB + 0.5 KB) + dk/dv staging 64 KB = 193 KB; the staging is
//     its own area, so the next item's K/V load under the epilogue.
//   dQ (item: 128 query rows of one (b, h); consumer: 64 rows). Q and dO
//     load once an item, lse and delta (two rows a thread) with plain
//     loads; the ring carries K_j and V_j (128 keys) up to the causal
//     limit. S = Q . K_j^T and dP = dO . V_j^T are m64n128k16 (half the
//     shared-memory reads a FLOP of 64-key tiles), dQ += dS . K_j (K_j
//     MN-major). Registers: S 64 + dP 64 + dq 64 + 32 packed. Shared
//     memory at d = 128: Q 32 KB + dO 32 KB + 2 stages x (K 32 KB + V
//     32 KB) + dq staging 32 KB = 224 KB.
// The tensor maps are built on the host per call (flash_common.cuh). The
// kernels allocate nothing and do not synchronise; they launch on the
// stream they are given.

#include <atomic>

#include "flash_common.cuh"

namespace {

using namespace edl::sm90;
using namespace edl::flash;

constexpr int kThreads = 384;  // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
// an item's rows (keys for dK/dV, queries for dQ), and dQ's key tiles
constexpr int kBlock = 128;
constexpr int kRowsWG = 64;    // rows of the item a consumer warpgroup owns
constexpr int kSub = 64;       // query rows a dK/dV ring tile
constexpr int kBlockBox = kBlock * 128;  // bytes of a 128-row box
constexpr int kSubBox = kSub * 128;      // bytes of a 64-row box
constexpr int kDkvStages = 2;
constexpr int kDqStages = 2;
// the producer's warp 1 walks the items beside the TMA issuer: 24
// registers spilled, 40 do not; the consumers keep 232
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// registers a thread at launch (__launch_bounds__(kThreads, 1)): what
// the producer gives up from them is what the consumers take
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
static_assert(kLaunchRegs - kProducerRegs ==
                  2 * (kConsumerRegs - kLaunchRegs),
              "setmaxnreg must balance within the CTA");
static_assert(kBlock == 2 * kRowsWG && kSub == kRowsWG,
              "two consumer warpgroups of wgmma's 64 rows");

struct Params {
  const float* lse;    // [B*H, T] compact, base 2
  const float* delta;  // [B*H, T] compact
  int T, H, groups;
  int n_blocks, n_items;  // 128-row blocks a head; x B * heads
  float scale;     // sm_scale * log2(e)
  float sm_scale;  // 1 / sqrt(d)
};

// the packed bf16 A operand of the 16-deep slices of an N-wide
// accumulator (the layout note of sm90.cuh)
template <int N>
__device__ __forceinline__ void pack_acc(uint32_t (&a)[N / 16][4],
                                         const float (&acc)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a[kk][e] = pack_bf16(acc[8 * kk + 2 * e], acc[8 * kk + 2 * e + 1]);
    }
  }
}

// Two score products over d, issued and committed, not waited on:
// c0 = A0 . B0^T and c1 = A1 . B1^T (64 x N, f32), A a 64-row slice of
// a 128-row tile and B an N-row tile, both K-major.
template <int D, int N>
__device__ __forceinline__ void issue_scores(float (&c0)[N / 2],
                                             float (&c1)[N / 2], uint64_t a0,
                                             uint64_t b0, uint64_t a1,
                                             uint64_t b1) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t a_off = (kk / 4) * kBlockBox + (kk % 4) * 32;
    const uint32_t b_off = (kk / 4) * (N * 128) + (kk % 4) * 32;
    if constexpr (N == 128) {
      wgmma_m64n128k16_ss(c0, desc_add(a0, a_off), desc_add(b0, b_off),
                          kk > 0);
      wgmma_m64n128k16_ss(c1, desc_add(a1, a_off), desc_add(b1, b_off),
                          kk > 0);
    } else {
      wgmma_m64n64k16_ss(c0, desc_add(a0, a_off), desc_add(b0, b_off),
                         kk > 0);
      wgmma_m64n64k16_ss(c1, desc_add(a1, a_off), desc_add(b1, b_off),
                         kk > 0);
    }
  }
  wgmma_commit();
}

// acc (64 x D) += A (registers, 64 x K) . B, B a K-row tile read
// MN-major (descriptor b); issued, not committed
template <int D, int K>
__device__ __forceinline__ void issue_grad(float (&acc)[D / 2],
                                           const uint32_t (&a)[K / 16][4],
                                           uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t bk = desc_add(b, kk * 16 * 128);
    if constexpr (D == 128) {
      wgmma_m64n128k16_rs(acc, a[kk], bk);
    } else {
      wgmma_m64n64k16_rs(acc, a[kk], bk);
    }
  }
}

// A consumer warpgroup's 64 x D f32 gradient rounded to bf16 into its
// staging area, in 64-row boxes of the 128-byte swizzle, ready for the
// TMA store.
template <int D>
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const float (&acc)[D / 2],
                                           int warp, int g, int t) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r_loc = 16 * warp + g + 8 * rr;  // row in the 64
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int chunk = (c % 8) ^ (r_loc % 8);
      *reinterpret_cast<uint32_t*>(dst + (c / 8) * kSubBox + r_loc * 128 +
                                   chunk * 16 + 4 * t) =
          pack_bf16(acc[4 * c + 2 * rr], acc[4 * c + 2 * rr + 1]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// -- dK/dV --------------------------------------------------------------------

template <int D>
struct DkvSmem {
  static constexpr int kKV = kBlock * D * 2;   // K or V of an item
  static constexpr int kSubT = kSub * D * 2;   // Q_i or dO_i
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKV;
  static constexpr int kQ = kV + kKV;                    // kDkvStages tiles
  static constexpr int kDO = kQ + kDkvStages * kSubT;    // kDkvStages tiles
  static constexpr int kDK = kDO + kDkvStages * kSubT;   // dk staging
  static constexpr int kDV = kDK + kKV;                  // dv staging
  static constexpr int kLse = kDV + kKV;                 // kDkvStages x 64 f32
  static constexpr int kDelta = kLse + kDkvStages * kSub * 4;
  static constexpr int kBar = kDelta + kDkvStages * kSub * 4;
  static constexpr int kBytes = kBar + 16 * 8 + 1024;  // + alignment slack
};

static_assert(DkvSmem<128>::kBytes <= 232448, "over the 227 KB a CTA has");

// One dK/dV item: 128 keys from k0 of one (b, KV head), against the
// 64-row query tiles i0 .. i0 + n_q - 1 of each of the head's query
// heads. Key block 0 sees every query tile, so the heaviest come first.
struct DkvItem {
  int b, kvh, k0, i0, n_q;
};

template <bool kCausal>
__device__ __forceinline__ DkvItem dkv_item(int index, const Params& p) {
  const int bkvs = p.n_items / p.n_blocks;  // B * KV
  const int kv = p.H / p.groups;
  const int bkv = index % bkvs;
  const int kt = index / bkvs;
  DkvItem w;
  w.b = bkv / kv;
  w.kvh = bkv % kv;
  w.k0 = kt * kBlock;
  // query tile i is live iff its last row 64 i + 63 >= k0
  w.i0 = kCausal ? w.k0 / kSub : 0;
  w.n_q = (p.T + kSub - 1) / kSub - w.i0;
  return w;
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_dk,
                         const __grid_constant__ CUtensorMap tm_dv,
                         Params p) {
  using S = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle is a function of address bits 4-9: align to 1 KB
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBar);
  uint64_t* kv_full = bars;
  uint64_t* kv_empty = bars + 1;
  uint64_t* full = bars + 2;                 // [kDkvStages]
  uint64_t* empty = bars + 2 + kDkvStages;   // [kDkvStages]
  float* s_lse = reinterpret_cast<float*>(smem + S::kLse);
  float* s_delta = reinterpret_cast<float*>(smem + S::kDelta);
  const int T = p.T;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumerWarps);
#pragma unroll
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(full + s, 1 + 32);  // the TMA issuer + warp 1's lse/delta
      mbar_init(empty + s, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: thread 0 loads K/V once an item and Q_i/dO_i into
    // the ring; warp 1 fills each stage's lse and delta ----
    setmaxnreg_dec<kProducerRegs>();
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      prefetch_tensormap(&tm_do);
      int it = 0;  // ring tiles loaded so far: stage and phase
      for (int r = 0;; ++r) {
        const int index = item_index(r);
        if (index >= p.n_items) break;
        const DkvItem w = dkv_item<kCausal>(index, p);
        mbar_wait(kv_empty, (r & 1) ^ 1);  // 1st item: free
        mbar_expect_tx(kv_full, 2 * S::kKV);
        load_tile<D, kBlock>(smem + S::kK, &tm_k, kv_full, w.kvh, w.k0, w.b);
        load_tile<D, kBlock>(smem + S::kV, &tm_v, kv_full, w.kvh, w.k0, w.b);
        for (int hg = 0; hg < p.groups; ++hg) {
          const int h = w.kvh * p.groups + hg;
          for (int i = w.i0; i < w.i0 + w.n_q; ++i, ++it) {
            const int s = it % kDkvStages;
            mbar_wait(empty + s, ((it / kDkvStages) & 1) ^ 1);
            mbar_expect_tx(full + s, 2 * S::kSubT);
            load_tile<D, kSub>(smem + S::kQ + s * S::kSubT, &tm_q, full + s,
                               h, i * kSub, w.b);
            load_tile<D, kSub>(smem + S::kDO + s * S::kSubT, &tm_do,
                               full + s, h, i * kSub, w.b);
          }
        }
      }
    } else if (warp == 1) {
      int it = 0;
      for (int r = 0;; ++r) {
        const int index = item_index(r);
        if (index >= p.n_items) break;
        const DkvItem w = dkv_item<kCausal>(index, p);
        for (int hg = 0; hg < p.groups; ++hg) {
          const long long row =
              static_cast<long long>(w.b * p.H + w.kvh * p.groups + hg) * T;
          for (int i = w.i0; i < w.i0 + w.n_q; ++i, ++it) {
            const int s = it % kDkvStages;
            mbar_wait(empty + s, ((it / kDkvStages) & 1) ^ 1);
#pragma unroll
            for (int half = 0; half < kSub / 32; ++half) {
              const int c = lane + 32 * half;
              const int q = i * kSub + c;
              // zeros past T keep the masked products finite
              s_lse[s * kSub + c] = q < T ? p.lse[row + q] : 0.f;
              s_delta[s * kSub + c] = q < T ? p.delta[row + q] : 0.f;
            }
            mbar_arrive(full + s);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // accumulator row group
    const int t = lane & 3;   // thread in the group

    // K-major: this warpgroup's 64 keys of K and V (A of S^T, dP^T), the
    // stage's Q_i and dO_i (B of S^T, dP^T); MN-major: Q_i and dO_i as B
    // of dK and dV (64-column groups one 8 KB box apart)
    const uint64_t k_a =
        desc_sw128(smem_u32(smem + S::kK) + cw * kRowsWG * 128, 16, 1024);
    const uint64_t v_a =
        desc_sw128(smem_u32(smem + S::kV) + cw * kRowsWG * 128, 16, 1024);
    const uint64_t q_k = desc_sw128(smem_u32(smem + S::kQ), 16, 1024);
    const uint64_t do_k = desc_sw128(smem_u32(smem + S::kDO), 16, 1024);
    const uint64_t q_mn = desc_sw128(smem_u32(smem + S::kQ), kSubBox, 1024);
    const uint64_t do_mn = desc_sw128(smem_u32(smem + S::kDO), kSubBox, 1024);
    unsigned char* sdk = smem + S::kDK + cw * (kRowsWG * D * 2);
    unsigned char* sdv = smem + S::kDV + cw * (kRowsWG * D * 2);

    float dk[D / 2], dv[D / 2];
    float st[32], dpt[32];
    zero(st);  // read (scaled by 0) once
    zero(dpt);
    uint32_t pa[kSub / 16][4], da[kSub / 16][4];

    const int my_turn = 3 + cw;
    const int next_turn = 4 - cw;
    if (cw == 1) named_bar_arrive(3, 256);

    int it = 0;  // ring tiles consumed so far: stage and phase
    for (int r = 0;; ++r) {
      const int index = item_index(r);
      if (index >= p.n_items) break;
      const bool final_item = item_index(r + 1) >= p.n_items;
      const DkvItem w = dkv_item<kCausal>(index, p);
      const int kw0 = w.k0 + kRowsWG * cw;  // this warpgroup's first key
      const int key0 = kw0 + 16 * warp + g;  // keys key0 and key0 + 8
      zero(dk);
      zero(dv);
      mbar_wait(kv_full, r & 1);
      const int n = p.groups * w.n_q;
      for (int j = 0; j < n; ++j, ++it) {
        const int s = it % kDkvStages;
        const uint32_t so = s * S::kSubT;
        const int q0 = (w.i0 + j % w.n_q) * kSub;
        mbar_wait(full + s, (it / kDkvStages) & 1);

        // S^T = K . Q_i^T and dP^T = V . dO_i^T: 64 keys x 64 queries,
        // issued in this warpgroup's turn
        named_bar_sync(my_turn, 256);
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
        issue_scores<D, kSub>(st, dpt, k_a, desc_add(q_k, so), v_a,
                              desc_add(do_k, so));
        named_bar_arrive(next_turn, 256);
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

        // P^T in st, dS^T in dpt; lse and delta by column (query)
        const float* sl = s_lse + s * kSub;
        const float* sd = s_delta + s * kSub;
        const float scale = p.scale;
        const float sm_scale = p.sm_scale;
        const bool need_mask = (kCausal && kw0 + kRowsWG - 1 > q0) ||
                               (q0 + kSub > T) || (kw0 + kRowsWG > T);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c = 8 * jj + 2 * t;
          const float2 l2 = *reinterpret_cast<const float2*>(sl + c);
          const float2 d2 = *reinterpret_cast<const float2*>(sd + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * jj + e;
            const float lse_c = (e & 1) ? l2.y : l2.x;
            const float delta_c = (e & 1) ? d2.y : d2.x;
            float pv = exp2_ftz(fmaf(st[i], scale, -lse_c));
            if (need_mask) {
              const int key = key0 + 8 * (e >> 1);
              const int query = q0 + c + (e & 1);
              if (query >= T || key >= T || (kCausal && key > query)) {
                pv = 0.f;
              }
            }
            st[i] = pv;
            dpt[i] = pv * (dpt[i] - delta_c) * sm_scale;
          }
        }
        pack_acc<kSub>(pa, st);
        pack_acc<kSub>(da, dpt);

        // dV += bf16(P^T) . dO_i and dK += bf16(dS^T) . Q_i, in turn;
        // warpgroup 1 passes no turn on after its very last product
        named_bar_sync(my_turn, 256);
        wgmma_fence();
        issue_grad<D, kSub>(dv, pa, desc_add(do_mn, so));
        issue_grad<D, kSub>(dk, da, desc_add(q_mn, so));
        wgmma_commit();
        if (cw == 0 || !final_item || j != n - 1) {
          named_bar_arrive(next_turn, 256);
        }
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);  // A is read from registers until the wait
        fence_regs(da);
        if (lane == 0) mbar_arrive(empty + s);
      }
      if (lane == 0) mbar_arrive(kv_empty);  // K and V are read no more

      // epilogue: dk and dv in bf16 through shared memory, one TMA store
      // a box (keys >= T are not written); the previous item's stores
      // must have read the staging area first
      if (tid == 0) bulk_wait_read<0>();
      named_bar_sync(1 + cw, 128);
      stage_rows<D>(sdk, dk, warp, g, t);
      stage_rows<D>(sdv, dv, warp, g, t);
      fence_proxy_async();
      named_bar_sync(1 + cw, 128);
      if (tid == 0 && kw0 < T) {
#pragma unroll
        for (int c = 0; c < D / kBoxCols; ++c) {
          tma_store_4d(&tm_dk, sdk + c * kSubBox, c * kBoxCols, w.kvh, kw0,
                       w.b);
          tma_store_4d(&tm_dv, sdv + c * kSubBox, c * kBoxCols, w.kvh, kw0,
                       w.b);
        }
        bulk_commit();
      }
    }
    // the last stores have read their shared memory before the CTA ends
    if (tid == 0) bulk_wait_read<0>();
  }
}

// -- dQ -----------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int kTile = kBlock * D * 2;  // Q, dO, K_j or V_j
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kTile;
  static constexpr int kK = kDO + kTile;               // kDqStages tiles
  static constexpr int kV = kK + kDqStages * kTile;    // kDqStages tiles
  static constexpr int kDQ = kV + kDqStages * kTile;   // dq staging
  static constexpr int kBar = kDQ + kTile;
  static constexpr int kBytes = kBar + 16 * 8 + 1024;  // + alignment slack
};

static_assert(DqSmem<128>::kBytes <= 232448, "over the 227 KB a CTA has");

// One dQ item: 128 query rows from q0 of one (b, h) against the 128-key
// tiles 0 .. n_tiles - 1 (up to the causal limit), numbered heaviest
// first as the forward's items are.
struct DqItem {
  int b, h, q0, n_tiles;
};

template <bool kCausal>
__device__ __forceinline__ DqItem dq_item(int index, const Params& p) {
  const int bhs = p.n_items / p.n_blocks;  // B * H
  const int bh = index % bhs;
  const int qt = p.n_blocks - 1 - index / bhs;
  DqItem w;
  w.b = bh / p.H;
  w.h = bh % p.H;
  w.q0 = qt * kBlock;
  w.n_tiles = (p.T + kBlock - 1) / kBlock;
  if (kCausal) w.n_tiles = min(w.n_tiles, qt + 1);  // keys <= q0 + 127
  return w;
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_dq,
                        Params p) {
  using S = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBar);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* full = bars + 2;                // [kDqStages]
  uint64_t* empty = bars + 2 + kDqStages;   // [kDqStages]
  const int T = p.T;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
#pragma unroll
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: Q and dO once an item, K_j and V_j into the ring ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      prefetch_tensormap(&tm_do);
      int it = 0;
      for (int r = 0;; ++r) {
        const int index = item_index(r);
        if (index >= p.n_items) break;
        const DqItem w = dq_item<kCausal>(index, p);
        const int kvh = w.h / p.groups;
        mbar_wait(q_empty, (r & 1) ^ 1);  // 1st item: free
        mbar_expect_tx(q_full, 2 * S::kTile);
        load_tile<D, kBlock>(smem + S::kQ, &tm_q, q_full, w.h, w.q0, w.b);
        load_tile<D, kBlock>(smem + S::kDO, &tm_do, q_full, w.h, w.q0, w.b);
        for (int j = 0; j < w.n_tiles; ++j, ++it) {
          const int s = it % kDqStages;
          mbar_wait(empty + s, ((it / kDqStages) & 1) ^ 1);
          mbar_expect_tx(full + s, 2 * S::kTile);
          load_tile<D, kBlock>(smem + S::kK + s * S::kTile, &tm_k, full + s,
                               kvh, j * kBlock, w.b);
          load_tile<D, kBlock>(smem + S::kV + s * S::kTile, &tm_v, full + s,
                               kvh, j * kBlock, w.b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;

    // K-major: this warpgroup's 64 rows of Q and dO (A of S, dP), the
    // stage's K_j and V_j (B of S, dP); MN-major: K_j as B of dQ
    const uint64_t q_a =
        desc_sw128(smem_u32(smem + S::kQ) + cw * kRowsWG * 128, 16, 1024);
    const uint64_t do_a =
        desc_sw128(smem_u32(smem + S::kDO) + cw * kRowsWG * 128, 16, 1024);
    const uint64_t k_k = desc_sw128(smem_u32(smem + S::kK), 16, 1024);
    const uint64_t v_k = desc_sw128(smem_u32(smem + S::kV), 16, 1024);
    const uint64_t k_mn = desc_sw128(smem_u32(smem + S::kK), kBlockBox, 1024);
    unsigned char* sdq = smem + S::kDQ + cw * (kRowsWG * D * 2);

    float dq[D / 2];
    float sc[kBlock / 2], dp[kBlock / 2];
    zero(sc);  // read (scaled by 0) once
    zero(dp);
    uint32_t da[kBlock / 16][4];

    const int my_turn = 3 + cw;
    const int next_turn = 4 - cw;
    if (cw == 1) named_bar_arrive(3, 256);

    int it = 0;
    for (int r = 0;; ++r) {
      const int index = item_index(r);
      if (index >= p.n_items) break;
      const bool final_item = item_index(r + 1) >= p.n_items;
      const DqItem w = dq_item<kCausal>(index, p);
      const int n = w.n_tiles;
      const int wg_row0 = w.q0 + kRowsWG * cw;
      const int row0 = wg_row0 + 16 * warp + g;  // rows row0 and row0 + 8
      const long long bh = static_cast<long long>(w.b) * p.H + w.h;
      float lse_r[2], delta_r[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row0 + 8 * rr;
        lse_r[rr] = row < T ? p.lse[bh * T + row] : 0.f;
        delta_r[rr] = row < T ? p.delta[bh * T + row] : 0.f;
      }
      zero(dq);
      mbar_wait(q_full, r & 1);
      for (int j = 0; j < n; ++j, ++it) {
        const int s = it % kDqStages;
        const uint32_t so = s * S::kTile;
        const int k0 = j * kBlock;
        mbar_wait(full + s, (it / kDqStages) & 1);

        // S = Q . K_j^T and dP = dO . V_j^T: 64 rows x 128 keys, issued
        // in this warpgroup's turn
        named_bar_sync(my_turn, 256);
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
        issue_scores<D, kBlock>(sc, dp, q_a, desc_add(k_k, so), do_a,
                                desc_add(v_k, so));
        named_bar_arrive(next_turn, 256);
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        if (lane == 0 && j == n - 1) mbar_arrive(q_empty);  // Q, dO done

        // dS in place of S
        const float scale = p.scale;
        const float sm_scale = p.sm_scale;
        const bool need_mask = (kCausal && k0 + kBlock - 1 > wg_row0) ||
                               (k0 + kBlock > T) || (wg_row0 + kRowsWG > T);
#pragma unroll
        for (int i = 0; i < kBlock / 2; ++i) {
          const int rr = (i >> 1) & 1;
          float pv = exp2_ftz(fmaf(sc[i], scale, -lse_r[rr]));
          if (need_mask) {
            const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
            const int row = row0 + 8 * rr;
            if (col >= T || row >= T || (kCausal && col > row)) pv = 0.f;
          }
          sc[i] = pv * (dp[i] - delta_r[rr]) * sm_scale;
        }
        pack_acc<kBlock>(da, sc);

        // dQ += bf16(dS) . K_j, in turn; warpgroup 1 passes no turn on
        // after its very last product
        named_bar_sync(my_turn, 256);
        wgmma_fence();
        issue_grad<D, kBlock>(dq, da, desc_add(k_mn, so));
        wgmma_commit();
        if (cw == 0 || !final_item || j != n - 1) {
          named_bar_arrive(next_turn, 256);
        }
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(da);
        if (lane == 0) mbar_arrive(empty + s);
      }

      // epilogue: dq in bf16 through shared memory, one TMA store a box
      if (tid == 0) bulk_wait_read<0>();
      named_bar_sync(1 + cw, 128);
      stage_rows<D>(sdq, dq, warp, g, t);
      fence_proxy_async();
      named_bar_sync(1 + cw, 128);
      if (tid == 0 && wg_row0 < T) {
#pragma unroll
        for (int c = 0; c < D / kBoxCols; ++c) {
          tma_store_4d(&tm_dq, sdq + c * kSubBox, c * kBoxCols, w.h, wg_row0,
                       w.b);
        }
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait_read<0>();
  }
}

// -- host side ----------------------------------------------------------------

struct Call {
  const void *q, *k, *v, *dout;
  void *o0, *o1;  // dq; or dk, dv
  int B, T, H, KV;
  const long long* s;  // (sb, st, sh) of q, k, v, dO, then the outputs
  Params p;
};

template <int D, bool kCausal>
cudaError_t launch_dq(const Call& c, cudaStream_t stream) {
  using S = DqSmem<D>;
  static std::atomic<bool> ready[kMaxDevices];
  int sms = 0;
  cudaError_t err = launch_setup(
      reinterpret_cast<const void*>(flash_bwd_dq_kernel<D, kCausal>),
      S::kBytes, ready, &sms);
  if (err != cudaSuccess) return err;
  const long long* s = c.s;
  CUtensorMap mq, mk, mv, mdo, mdq;
  if (!make_map(&mq, c.q, D, c.H, c.T, c.B, s[0], s[1], s[2], kBlock) ||
      !make_map(&mk, c.k, D, c.KV, c.T, c.B, s[3], s[4], s[5], kBlock) ||
      !make_map(&mv, c.v, D, c.KV, c.T, c.B, s[6], s[7], s[8], kBlock) ||
      !make_map(&mdo, c.dout, D, c.H, c.T, c.B, s[9], s[10], s[11], kBlock) ||
      !make_map(&mdq, c.o0, D, c.H, c.T, c.B, s[12], s[13], s[14], kRowsWG)) {
    return cudaErrorInvalidValue;
  }
  const int grid = c.p.n_items < sms ? c.p.n_items : sms;
  flash_bwd_dq_kernel<D, kCausal>
      <<<grid, kThreads, S::kBytes, stream>>>(mq, mk, mv, mdo, mdq, c.p);
  return cudaGetLastError();
}

template <int D, bool kCausal>
cudaError_t launch_dkv(const Call& c, cudaStream_t stream) {
  using S = DkvSmem<D>;
  static std::atomic<bool> ready[kMaxDevices];
  int sms = 0;
  cudaError_t err = launch_setup(
      reinterpret_cast<const void*>(flash_bwd_dkv_kernel<D, kCausal>),
      S::kBytes, ready, &sms);
  if (err != cudaSuccess) return err;
  const long long* s = c.s;
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  if (!make_map(&mq, c.q, D, c.H, c.T, c.B, s[0], s[1], s[2], kSub) ||
      !make_map(&mk, c.k, D, c.KV, c.T, c.B, s[3], s[4], s[5], kBlock) ||
      !make_map(&mv, c.v, D, c.KV, c.T, c.B, s[6], s[7], s[8], kBlock) ||
      !make_map(&mdo, c.dout, D, c.H, c.T, c.B, s[9], s[10], s[11], kSub) ||
      !make_map(&mdk, c.o0, D, c.KV, c.T, c.B, s[12], s[13], s[14],
                kRowsWG) ||
      !make_map(&mdv, c.o1, D, c.KV, c.T, c.B, s[15], s[16], s[17],
                kRowsWG)) {
    return cudaErrorInvalidValue;
  }
  const int grid = c.p.n_items < sms ? c.p.n_items : sms;
  flash_bwd_dkv_kernel<D, kCausal><<<grid, kThreads, S::kBytes, stream>>>(
      mq, mk, mv, mdo, mdk, mdv, c.p);
  return cudaGetLastError();
}

template <bool kDq>
int dispatch(const Call& c, int D, int causal, cudaStream_t st) {
  cudaError_t err;
  if (D == 64) {
    err = kDq ? (causal ? launch_dq<64, true>(c, st)
                        : launch_dq<64, false>(c, st))
              : (causal ? launch_dkv<64, true>(c, st)
                        : launch_dkv<64, false>(c, st));
  } else if (D == 128) {
    err = kDq ? (causal ? launch_dq<128, true>(c, st)
                        : launch_dq<128, false>(c, st))
              : (causal ? launch_dkv<128, true>(c, st)
                        : launch_dkv<128, false>(c, st));
  } else {
    err = cudaErrorInvalidValue;
  }
  return int(err);
}

bool fill(Call& c, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, const void* delta, int B, int T,
          int H, int KV, const long long* s, float scale, float sm_scale,
          bool dq) {
  if (T < 1 || B < 1 || KV < 1 || H % KV != 0 || lse == nullptr ||
      delta == nullptr || s == nullptr) {
    return false;
  }
  c.q = q;
  c.k = k;
  c.v = v;
  c.dout = dout;
  c.o0 = c.o1 = nullptr;
  c.B = B;
  c.T = T;
  c.H = H;
  c.KV = KV;
  c.s = s;
  c.p.lse = static_cast<const float*>(lse);
  c.p.delta = static_cast<const float*>(delta);
  c.p.T = T;
  c.p.H = H;
  c.p.groups = H / KV;
  c.p.n_blocks = (T + kBlock - 1) / kBlock;
  c.p.n_items = c.p.n_blocks * B * (dq ? H : KV);
  c.p.scale = scale;
  c.p.sm_scale = sm_scale;
  return true;
}

}  // namespace

// q/dO [B,T,H,D], k/v [B,T,KV,D], lse/delta f32 [B*H, T] contiguous,
// dq [B,T,H,D]; strides in elements, the last dimension contiguous,
// every row 16-byte aligned (the wrapper checks). Returns the CUDA error
// of the launch (0 = launched).
extern "C" int flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int T, int H,
    int KV, int D, const long long* strides, float scale, float sm_scale,
    int causal, void* stream) {
  Call c;
  if (dq == nullptr || !fill(c, q, k, v, dout, lse, delta, B, T, H, KV,
                             strides, scale, sm_scale, true)) {
    return int(cudaErrorInvalidValue);
  }
  c.o0 = dq;
  return dispatch<true>(c, D, causal, static_cast<cudaStream_t>(stream));
}

// As flash_bwd_dq_bf16, writing dk/dv [B,T,KV,D] (summed over each KV
// head's query heads) instead of dq. strides: q, k, v, dO, dk, dv.
extern "C" int flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int T,
    int H, int KV, int D, const long long* strides, float scale,
    float sm_scale, int causal, void* stream) {
  Call c;
  if (dk == nullptr || dv == nullptr ||
      !fill(c, q, k, v, dout, lse, delta, B, T, H, KV, strides, scale,
            sm_scale, false)) {
    return int(cudaErrorInvalidValue);
  }
  c.o0 = dk;
  c.o1 = dv;
  return dispatch<false>(c, D, causal, static_cast<cudaStream_t>(stream));
}
