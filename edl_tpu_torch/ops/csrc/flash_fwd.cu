// Causal / full GQA flash-attention forward for Hopper (sm_90a), bf16.
//
// Replaces edl_tpu/ops/flash_attention.py::_flash_kernel on both of its
// paths: the primal, no-gradient one (with_lse=False, entry
// flash_fwd_bf16), which every serving prefill runs when
// LlamaConfig.use_flash is set, and the training one (with_lse=True,
// _flash_fwd, entry flash_fwd_lse_bf16), which also writes the per-row
// base-2 logsumexp the backward kernels (flash_bwd.cu) consume.
//
// What it computes is _flash_kernel's function, not its grid:
//   s = (q . k^T) * sm_scale * log2(e)         f32 accumulation
//   causal mask rows >= cols (NEG_INF), only on tiles that cross the
//   diagonal or the ragged T edge; tiles above the diagonal are never
//   loaded
//   base-2 online softmax: m_new = max(m, rowmax(s)), p = exp2(s - m_new),
//   alpha = exp2(m - m_new), l = l*alpha + rowsum(p) (p in f32),
//   acc = acc*alpha + bf16(p) . v                f32 accumulation
//   out = bf16(acc / max(l, 1e-20))
//   with lse: lse = m + log2(max(l, 1e-20)), f32, one value per valid
//   row in a compact [B*H, T] array (rows past T are not written)
// Query head h reads KV head h / (H / KV); K/V are never repeated.
// Three f32 shortcuts, each far inside the tolerance the card tests hold
// it to against the plain version: the scale is folded into the
// exponent (rowmax of the raw scores, max(x) * c == max(x * c) for c > 0;
// p = exp2(fma(s, c, -m_new)), one rounding fewer than (s * c) - m_new);
// exp2 is the one-op ex2.approx.ftz (values below 2^-126 flush to 0);
// and out is acc times one reciprocal of l a row. A masked score is -inf;
// every row keeps at least one live key in every tile it visits, so the
// running max is the reference's.
//
// Bound on an H100 SXM: the larger of FLOPs / 989 TF/s (bf16 tensor
// cores) and bytes / 3.35 TB/s (q, k, v read once, out and lse written
// once). At the serving and training shapes (d = 128, T >= 128) it is
// bound by operations, so the design is about keeping the tensor cores
// fed (FlashAttention-3's shape):
//   * persistent: one CTA of 3 warpgroups an SM walks over work items, a
//     128-row query tile of one (b, h) each, numbered heaviest causal
//     tile first and dealt back and forth over the CTAs; the next item's
//     Q and first K/V tiles load while the current one finishes;
//   * warpgroup 0 is the producer: it gives up registers (setmaxnreg)
//     and one thread issues every TMA load -- Q once an item, K and V
//     tiles of 128 keys into a 2-stage ring, each with its own full/empty
//     mbarrier pair, so Q.K^T can start before V has landed;
//   * warpgroups 1-2 are consumers, 64 query rows each (wgmma's M); they
//     take the registers the producer gave up. S = Q.K^T is
//     wgmma m64n128k16 with both operands K-major in shared memory;
//     softmax runs on the 64 f32 accumulators of each thread; P is
//     re-packed in registers as the A operand of O += P.V (wgmma with A
//     from registers, V read MN-major through the transpose bit, so V is
//     never copied transposed). S of tile j and P.V of tile j - 1 are
//     issued together, so the softmax of S_j runs under P.V; and the two
//     warpgroups take turns to issue (ping-pong on named barriers), so
//     one's softmax runs under the other's products. A ring stage is
//     released only after wgmma.wait_group has retired its reader;
//   * every tile is in the 128-byte swizzle that TMA writes and the
//     wgmma descriptors read (sm90.cuh); at d = 128 a row is 256 bytes,
//     so a tile is two 64-column boxes. Shared memory at d = 128:
//     Q 32 KB + 2 x (K 32 KB + V 32 KB) + O 32 KB = 192 KB, one CTA an SM;
//   * rows past T arrive as zeros from TMA; columns >= T are masked in
//     the kernel (a zero score is not -inf); O leaves through shared
//     memory in one TMA store a 64-row box, which drops rows >= T.
// The tensor maps are built on the host per call (cuTensorMapEncodeTiled,
// rank 4: d, heads, T, B, with the caller's strides), reached through
// cudaGetDriverEntryPointByVersion of the CUDA runtime that nvcc links
// (_build.NVCC_FLAGS: -cudart static), so the build links no libcuda.
// Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -cudart static
// and called through the plain C entry points (ctypes). The kernel
// allocates nothing and does not synchronise; it launches on the stream
// it is given.

#include <atomic>

#include "flash_common.cuh"

namespace {

using namespace edl::sm90;
using namespace edl::flash;

constexpr int kBQ = 128;      // query rows a CTA
constexpr int kBK = 128;      // keys a K/V tile
constexpr int kRowsWG = 64;   // query rows a consumer warpgroup
constexpr int kStages = 2;    // K/V ring depth
constexpr int kThreads = 384; // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kBoxBytes = 128 * 128;  // a 128-row box
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(128 * (kProducerRegs + 2 * kConsumerRegs) <= 65536,
              "the warpgroups' registers must fit in the SM's 64 K");
static_assert(kBQ == kBK, "the causal tile count assumes square tiles");
constexpr float kNegInf = -1e30f;

template <int D>
struct Smem {
  static constexpr int kTile = kBK * D * 2;  // bytes of a 128-row tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;                 // kStages tiles
  static constexpr int kV = kK + kStages * kTile;       // kStages tiles
  static constexpr int kO = kV + kStages * kTile;       // O staging
  static constexpr int kBar = kO + kTile;               // 10 mbarriers
  static constexpr int kBytes = kBar + 16 * 8 + 1024;   // + alignment slack
};

struct Params {
  float* lse;  // [B*H, T] compact, written only by the kWithLse variant
  int T, H, groups;
  int n_qtiles, n_items;  // 128-row query tiles a head; x B*H
  float scale;  // sm_scale * log2(e)
};

// One work item: a 128-row query tile of one (b, h), numbered heaviest
// first (all heads' last causal tiles, then the ones before) and dealt
// by item_index (flash_common.cuh).
struct Item {
  int b, h, q0, n_tiles;
};

template <bool kCausal>
__device__ __forceinline__ Item item_at(int index, const Params& p) {
  const int bhs = p.n_items / p.n_qtiles;  // B * H
  const int bh = index % bhs;
  const int qt = p.n_qtiles - 1 - index / bhs;
  Item w;
  w.b = bh / p.H;
  w.h = bh % p.H;
  w.q0 = qt * kBQ;
  w.n_tiles = (p.T + kBK - 1) / kBK;
  if (kCausal) w.n_tiles = min(w.n_tiles, qt + 1);  // keys <= q0 + 127
  return w;
}

// S = Q . K^T for 64 query rows x 128 keys (f32), issued, not waited on
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint64_t dq,
                                         uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_m64n128k16_ss(sc, desc_add(dq, off), desc_add(dk, off), kk > 0);
  }
  wgmma_commit();
}

// O += P . V over 128 keys (16 a slice), issued, not waited on
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[kBK / 16][4],
                                         uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t b = desc_add(dv, kk * 16 * 128);
    if constexpr (D == 128) {
      wgmma_m64n128k16_rs(o, pa[kk], b);
    } else {
      wgmma_m64n64k16_rs(o, pa[kk], b);
    }
  }
  wgmma_commit();
}

// Online softmax of one tile, base 2, in place: the raw scores sc of keys
// k0 .. k0 + 127 become p = exp2(s * scale - m_new) (f32); m and l move
// on, alpha = exp2(m_old - m_new) is returned for the accumulator.
// r = 0: row row0, r = 1: row0 + 8; a row's 32 values sit in the four
// threads of its group.
template <bool kCausal>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool need_mask, int k0, int row0,
                                             int t, int T, float scale) {
  if (need_mask) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      const int row = row0 + 8 * ((i >> 1) & 1);
      if (col >= T || (kCausal && col > row)) sc[i] = -INFINITY;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      mx = fmaxf(mx, fmaxf(sc[4 * c + 2 * r], sc[4 * c + 2 * r + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * scale);
    const float neg_m = -m_new;
    alpha[r] = exp2_ftz(m[r] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float p0 = exp2_ftz(fmaf(sc[4 * c + 2 * r], scale, neg_m));
      const float p1 = exp2_ftz(fmaf(sc[4 * c + 2 * r + 1], scale, neg_m));
      sc[4 * c + 2 * r] = p0;
      sc[4 * c + 2 * r + 1] = p1;
      sum += p0 + p1;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[r] = l[r] * alpha[r] + sum;
    m[r] = m_new;
  }
}

// P rounded to bf16, as the register A operand of each 16-key slice
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kBK / 16][4],
                                       const float (&sc)[64]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    }
  }
}

template <int D, bool kCausal, bool kWithLse>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_o, Params p) {
  using S = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle is a function of address bits 4-9: align to 1 KB
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBar);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;   // [kStages]
  uint64_t* v_full = bars + 3;   // [kStages]
  uint64_t* k_empty = bars + 5;  // [kStages]
  uint64_t* v_empty = bars + 7;  // [kStages]
  uint64_t* q_empty = bars + 9;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, kConsumerWarps);
      mbar_init(v_empty + s, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps Q and the K/V ring full, item
    // after item; the next item's Q and first tiles load under the
    // consumers' last products and epilogue of the current one ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      int it = 0;  // K/V tiles loaded so far: ring stage and phase
      for (int r = 0;; ++r) {
        const int index = item_index(r);
        if (index >= p.n_items) break;
        const Item w = item_at<kCausal>(index, p);
        const int kvh = w.h / p.groups;
        mbar_wait(q_empty, (r & 1) ^ 1);  // 1st item: free
        mbar_expect_tx(q_full, S::kTile);
        load_tile<D, kBK>(smem + S::kQ, &tm_q, q_full, w.h, w.q0, w.b);
        for (int j = 0; j < w.n_tiles; ++j, ++it) {
          const int s = it & 1;
          const uint32_t free_parity = ((it >> 1) & 1) ^ 1;  // 1st use: free
          mbar_wait(k_empty + s, free_parity);
          mbar_expect_tx(k_full + s, S::kTile);
          load_tile<D, kBK>(smem + S::kK + s * S::kTile, &tm_k, k_full + s,
                            kvh, j * kBK, w.b);
          mbar_wait(v_empty + s, free_parity);
          mbar_expect_tx(v_full + s, S::kTile);
          load_tile<D, kBK>(smem + S::kV + s * S::kTile, &tm_v, v_full + s,
                            kvh, j * kBK, w.b);
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
    const int g = lane >> 2;  // accumulator row group
    const int t = lane & 3;   // thread in the group
    const int T = p.T;
    const float scale = p.scale;

    // K-major descriptors (Q rows of this warpgroup, K tile): 8-row
    // groups 1024 bytes apart; MN-major V: 64-column groups one box
    // apart, 8-key groups 1024 bytes apart
    const uint64_t dq =
        desc_sw128(smem_u32(smem + S::kQ) + cw * kRowsWG * 128, 16, 1024);
    const uint64_t dk0 = desc_sw128(smem_u32(smem + S::kK), 16, 1024);
    const uint64_t dv0 = desc_sw128(smem_u32(smem + S::kV), kBoxBytes, 1024);
    // this warpgroup's 64 output rows, staged for the TMA store in 64-row
    // boxes of the same 128-byte swizzle
    unsigned char* so = smem + S::kO + cw * (kRowsWG * D * 2);

    float o[D / 2];
    float sc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;  // read (scaled by 0) once
    uint32_t pa[kBK / 16][4];
    float m_run[2], l_run[2], alpha[2];

    // Ping-pong: the two consumer warpgroups take turns to issue their
    // products (named barriers 1 and 2), so one's softmax runs while the
    // other's products hold the tensor cores. Warpgroup 0 goes first.
    const int my_turn = 1 + cw;
    const int next_turn = 2 - cw;
    if (cw == 1) named_bar_arrive(1, 256);

    int it = 0;  // K/V tiles consumed so far: ring stage and phase
    for (int r = 0;; ++r) {
      const int index = item_index(r);
      if (index >= p.n_items) break;
      const bool final_item = item_index(r + 1) >= p.n_items;
      const Item w = item_at<kCausal>(index, p);
      const int n = w.n_tiles;
      const int wg_row0 = w.q0 + kRowsWG * cw;
      const int row0 = wg_row0 + 16 * warp + g;  // rows row0 and row0 + 8
      auto need_mask = [&](int k0) {
        return (kCausal && k0 + kBK - 1 > wg_row0) || (k0 + kBK > T);
      };
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      m_run[0] = m_run[1] = kNegInf;
      l_run[0] = l_run[1] = 0.f;

      // tile 0: S only
      mbar_wait(q_full, r & 1);
      mbar_wait(k_full + (it & 1), (it >> 1) & 1);
      named_bar_sync(my_turn, 256);
      wgmma_fence();
      issue_qk<D>(sc, dq, desc_add(dk0, (it & 1) * S::kTile));
      named_bar_arrive(next_turn, 256);
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) {
        mbar_arrive(k_empty + (it & 1));
        if (n == 1) mbar_arrive(q_empty);  // Q is read by no more products
      }
      softmax_tile<kCausal>(sc, m_run, l_run, alpha, need_mask(0), 0, row0,
                            t, T, scale);
      pack_p(pa, sc);

      // tile j: S_j = Q . K_j^T and O += P_{j-1} . V_{j-1} issued
      // together; the softmax of S_j runs while P_{j-1} . V_{j-1} is in
      // flight
      for (int j = 1; j < n; ++j) {
        const int cur = it + j;
        const int prev = cur - 1;
        mbar_wait(k_full + (cur & 1), (cur >> 1) & 1);
        mbar_wait(v_full + (prev & 1), (prev >> 1) & 1);
        named_bar_sync(my_turn, 256);
        fence_regs(sc);
        fence_regs(o);
        wgmma_fence();
        issue_qk<D>(sc, dq, desc_add(dk0, (cur & 1) * S::kTile));
        issue_pv<D>(o, pa, desc_add(dv0, (prev & 1) * S::kTile));
        named_bar_arrive(next_turn, 256);
        wgmma_wait<1>();  // S_j has landed; P_{j-1} . V_{j-1} may still run
        fence_regs(sc);
        if (lane == 0) {
          mbar_arrive(k_empty + (cur & 1));
          if (j == n - 1) mbar_arrive(q_empty);
        }
        softmax_tile<kCausal>(sc, m_run, l_run, alpha, need_mask(j * kBK),
                              j * kBK, row0, t, T, scale);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);  // A is read from registers until the wait
        if (lane == 0) mbar_arrive(v_empty + (prev & 1));
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        pack_p(pa, sc);
      }

      // the last tile's P . V; warpgroup 1 passes no turn on after its
      // very last product (warpgroup 0 waits for none)
      const int last = it + n - 1;
      mbar_wait(v_full + (last & 1), (last >> 1) & 1);
      named_bar_sync(my_turn, 256);
      fence_regs(o);
      wgmma_fence();
      issue_pv<D>(o, pa, desc_add(dv0, (last & 1) * S::kTile));
      if (cw == 0 || !final_item) named_bar_arrive(next_turn, 256);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(v_empty + (last & 1));
      it += n;

      // epilogue: O / l in bf16 through shared memory into one TMA store
      // a box (rows >= T are not written); the previous item's store
      // must have read the staging buffer first
      if (tid == 0) bulk_wait_read<0>();
      named_bar_sync(3 + cw, 128);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r_loc = 16 * warp + g + 8 * rr;  // row in the 64
        const float l = fmaxf(l_run[rr], 1e-20f);
        const float inv_l = 1.f / l;
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          const int chunk = (c % 8) ^ (r_loc % 8);
          *reinterpret_cast<uint32_t*>(so + (c / 8) * (kRowsWG * 128) +
                                       r_loc * 128 + chunk * 16 + 4 * t) =
              pack_bf16(o[4 * c + 2 * rr] * inv_l,
                        o[4 * c + 2 * rr + 1] * inv_l);
        }
        // the four threads of a row group hold the same m and l: one
        // writes
        const int row = row0 + 8 * rr;
        if (kWithLse && t == 0 && row < T) {
          p.lse[static_cast<long long>(w.b * p.H + w.h) * T + row] =
              m_run[rr] + log2f(l);
        }
      }
      fence_proxy_async();
      named_bar_sync(3 + cw, 128);
      if (tid == 0 && wg_row0 < T) {
#pragma unroll
        for (int c = 0; c < D / kBoxCols; ++c) {
          tma_store_4d(&tm_o, so + c * (kRowsWG * 128), c * kBoxCols, w.h,
                       wg_row0, w.b);
        }
        bulk_commit();
      }
    }
    // the last store has read its shared memory before the CTA ends
    if (tid == 0) bulk_wait_read<0>();
  }
}

// -- host side ----------------------------------------------------------------

struct Call {
  const void *q, *k, *v, *o;
  int B, T, H, KV;
  long long s[12];  // q, k, v, o: (sb, st, sh) each
  Params p;
};

template <int D, bool kCausal, bool kWithLse>
cudaError_t launch(const Call& c, cudaStream_t stream) {
  using S = Smem<D>;
  static std::atomic<bool> ready[kMaxDevices];
  int sms = 0;
  cudaError_t err = launch_setup(
      reinterpret_cast<const void*>(flash_fwd_kernel<D, kCausal, kWithLse>),
      S::kBytes, ready, &sms);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, c.q, D, c.H, c.T, c.B, c.s[0], c.s[1], c.s[2], kBQ) ||
      !make_map(&mk, c.k, D, c.KV, c.T, c.B, c.s[3], c.s[4], c.s[5], kBK) ||
      !make_map(&mv, c.v, D, c.KV, c.T, c.B, c.s[6], c.s[7], c.s[8], kBK) ||
      !make_map(&mo, c.o, D, c.H, c.T, c.B, c.s[9], c.s[10], c.s[11],
                kRowsWG)) {
    return cudaErrorInvalidValue;
  }
  // persistent: one CTA an SM (160 KB of shared memory at d = 128, 384
  // threads at up to 240 registers), each working through its items
  const int grid = c.p.n_items < sms ? c.p.n_items : sms;
  flash_fwd_kernel<D, kCausal, kWithLse>
      <<<grid, kThreads, S::kBytes, stream>>>(mq, mk, mv, mo, c.p);
  return cudaGetLastError();
}

template <bool kWithLse>
int dispatch(const Call& c, int D, int causal, cudaStream_t st) {
  cudaError_t err;
  if (D == 64) {
    err = causal ? launch<64, true, kWithLse>(c, st)
                 : launch<64, false, kWithLse>(c, st);
  } else if (D == 128) {
    err = causal ? launch<128, true, kWithLse>(c, st)
                 : launch<128, false, kWithLse>(c, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return int(err);
}

bool fill(Call& c, const void* q, const void* k, const void* v, void* o,
          float* lse, int B, int T, int H, int KV, const long long* s,
          float scale) {
  if (T < 1 || B < 1 || KV < 1 || H % KV != 0) return false;
  c.q = q;
  c.k = k;
  c.v = v;
  c.o = o;
  c.B = B;
  c.T = T;
  c.H = H;
  c.KV = KV;
  for (int i = 0; i < 12; ++i) c.s[i] = s[i];
  c.p.lse = lse;
  c.p.T = T;
  c.p.H = H;
  c.p.groups = H / KV;
  c.p.n_qtiles = (T + kBQ - 1) / kBQ;
  c.p.n_items = c.p.n_qtiles * B * H;
  c.p.scale = scale;
  return true;
}

}  // namespace

// q [B,T,H,D], k/v [B,T,KV,D], o [B,T,H,D]; strides in elements, the
// last dimension contiguous, every row 16-byte aligned (the wrapper
// checks). Returns the CUDA error of the launch (0 = launched).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, int B, int T, int H, int KV, int D,
                              long long q_sb, long long q_st, long long q_sh,
                              long long k_sb, long long k_st, long long k_sh,
                              long long v_sb, long long v_st, long long v_sh,
                              long long o_sb, long long o_st, long long o_sh,
                              float scale, int causal, void* stream) {
  const long long s[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                           v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  Call c;
  if (!fill(c, q, k, v, o, nullptr, B, T, H, KV, s, scale)) {
    return int(cudaErrorInvalidValue);
  }
  return dispatch<false>(c, D, causal, static_cast<cudaStream_t>(stream));
}

// As flash_fwd_bf16, plus lse: f32 [B*H, T] contiguous (row b*H + h).
extern "C" int flash_fwd_lse_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int T, int H, int KV, int D, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh, long long o_sb,
    long long o_st, long long o_sh, float scale, int causal, void* stream) {
  const long long s[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                           v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  Call c;
  if (lse == nullptr ||
      !fill(c, q, k, v, o, static_cast<float*>(lse), B, T, H, KV, s, scale)) {
    return int(cudaErrorInvalidValue);
  }
  return dispatch<true>(c, D, causal, static_cast<cudaStream_t>(stream));
}
