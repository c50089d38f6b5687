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
// Key tiles above the causal diagonal are skipped with the forward's
// predicate (k0 <= q0 + 63 on 64-row tiles), so the two directions
// never desynchronize.
//
// GQA: the dK/dV kernel owns one KV head and loops over the H / KV query
// heads that read it, so the group sum the reference runs in XLA after
// its kernel (per-query-head [B*H, T, d] f32 dk/dv, then summed) happens
// in the kernel's f32 registers: no per-query-head buffer, no atomics.
// dk/dv are rounded to bf16 once, after the sum.
//
// Bound on an H100 SXM: the larger of FLOPs / 989 TF/s and bytes /
// 3.35 TB/s. dQ needs three products per live (row, key) pair (S, dP,
// dS.K: 6*d FLOPs), dK/dV four (S, dP, P^T.dO, dS^T.Q: 8*d); both read
// q, k, v, dO, lse, delta once and write their gradient once. At d = 128
// and T >= 128 both are bound by operations.
//
// Design, simple by intent (as flash_fwd.cu): 4 warps, 16 rows each,
// mma.sync m16n8k16 bf16 -> f32, 64-row tiles staged through padded
// shared memory, no cp.async / TMA / wgmma.
//   dQ:   one block per (b*h, 64-query tile); Q and dO stay in shared
//         memory, a loop walks the K/V tiles up to the causal limit; S
//         and dP are 16 x 64 per warp in registers, dS is re-packed in
//         registers as the A operand of dS.K. dq: 64 f32 registers.
//   dK/dV: one block per (b*kvh, 64-key tile); K and V stay in shared
//         memory, loops walk the group's query heads and the query tiles
//         from the diagonal on. The products are taken transposed,
//         S^T = K.Q^T and dP^T = V.dO^T, so each warp's accumulator has
//         key rows and is already the A fragment of P^T.dO and dS^T.Q
//         (the re-pack flash_fwd.cu uses for P.V); lse and delta are then
//         indexed by column, from shared memory. dk and dv take 128 f32
//         registers a thread, so S^T/dP^T are formed 32 queries at a time
//         (32 registers, not 64) to stay clear of spills.
// The kernels allocate nothing and do not synchronise; they launch on
// the stream they are given.

#include "mma_bf16.cuh"

namespace {

using namespace edl;
constexpr int kSub = 32;  // query columns per S^T slice in dK/dV

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // [B*H, T] compact, base 2
  const float* delta;  // [B*H, T] compact
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int T, H, groups;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long do_sb, do_st, do_sh;
  long long dq_sb, dq_st, dq_sh;
  long long dk_sb, dk_st, dk_sh;
  long long dv_sb, dv_st, dv_sh;
  float scale;     // sm_scale * log2(e)
  float sm_scale;  // 1 / sqrt(d)
};

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(Args p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + kTile * LD;
  __nv_bfloat16* sK = sdO + kTile * LD;
  __nv_bfloat16* sV = sK + kTile * LD;

  const int qt = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kvh = h / p.groups;
  const int q0 = qt * kTile;
  const int T = p.T;

  const __nv_bfloat16* kg = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + kvh * p.v_sh;
  load_tile<D, LD>(sQ, p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_st, p.q_st,
                   min(kTile, T - q0));
  load_tile<D, LD>(sdO, p.dout + b * p.do_sb + h * p.do_sh + q0 * p.do_st,
                   p.do_st, min(kTile, T - q0));

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // rows row0 and row0 + 8

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long i = static_cast<long long>(bh) * T + row;
    lse_r[r] = row < T ? p.lse[i] : 0.f;
    delta_r[r] = row < T ? p.delta[i] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  int n_tiles = (T + kTile - 1) / kTile;
  if (kCausal) n_tiles = min(n_tiles, qt + 1);  // the forward's skip

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile is no longer read
    load_tile<D, LD>(sK, kg + k0 * p.k_st, p.k_st, min(kTile, T - k0));
    load_tile<D, LD>(sV, vg + k0 * p.v_st, p.v_st, min(kTile, T - k0));
    __syncthreads();

    // S = Q . K^T and dP = dO . V^T, 16 rows x 64 keys per warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t aq[4], ado[4];
      mma_a_from_smem<LD>(aq, sQ + (warp * 16) * LD, kc * 16, g, t);
      mma_a_from_smem<LD>(ado, sdO + (warp * 16) * LD, kc * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        mma_b_nmajor<LD>(b0, b1, sK + (nt * 8) * LD + kc * 16, g, t);
        mma_bf16(s[nt], aq, b0, b1);
        mma_b_nmajor<LD>(b0, b1, sV + (nt * 8) * LD + kc * 16, g, t);
        mma_bf16(dp[nt], ado, b0, b1);
      }
    }

    // ds in place of s
    const bool need_mask = (kCausal && k0 + kTile - 1 > q0) ||
                           (k0 + kTile > T) || (q0 + kTile > T);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pv = exp2f(s[nt][e] * p.scale - lse_r[r]);
        if (need_mask) {
          const int col = k0 + nt * 8 + 2 * t + (e & 1);
          const int row = row0 + 8 * r;
          if (col >= T || row >= T || (kCausal && col > row)) pv = 0.f;
        }
        s[nt][e] = pv * (dp[nt][e] - delta_r[r]) * p.sm_scale;
      }
    }

    // dq += bf16(dS) . K
#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      uint32_t a[4];
      mma_a_from_acc(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        mma_b_kmajor<LD>(b0, b1, sK + (kc * 16) * LD + dt * 8, g, t);
        mma_bf16(acc[dt], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= T) continue;
    __nv_bfloat16* out = p.dq + b * p.dq_sb + h * p.dq_sh + row * p.dq_st;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(out + dt * 8 + 2 * t) =
          pack_f32(acc[dt][2 * r], acc[dt][2 * r + 1]);
    }
  }
}

template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(Args p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kTile * LD;
  __nv_bfloat16* sQ = sV + kTile * LD;
  __nv_bfloat16* sdO = sQ + kTile * LD;
  float* sL = reinterpret_cast<float*>(sdO + kTile * LD);
  float* sD = sL + kTile;

  const int kt = blockIdx.x;
  const int bkv = blockIdx.y;
  const int KV = p.H / p.groups;
  const int b = bkv / KV;
  const int kvh = bkv % KV;
  const int k0 = kt * kTile;
  const int T = p.T;

  load_tile<D, LD>(sK, p.k + b * p.k_sb + kvh * p.k_sh + k0 * p.k_st, p.k_st,
                   min(kTile, T - k0));
  load_tile<D, LD>(sV, p.v + b * p.v_sb + kvh * p.v_sh + k0 * p.v_st, p.v_st,
                   min(kTile, T - k0));

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int krow0 = k0 + warp * 16 + g;  // key rows krow0 and krow0 + 8

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  }

  const int n_qt = (T + kTile - 1) / kTile;
  // query tile i is live iff k0 <= i*64 + 63, i.e. i >= kt (the same
  // predicate as the forward's and the dQ sweep's)
  const int i0 = kCausal ? kt : 0;

  for (int hg = 0; hg < p.groups; ++hg) {
    const int h = kvh * p.groups + hg;
    const long long bh = static_cast<long long>(b) * p.H + h;
    const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* dog = p.dout + b * p.do_sb + h * p.do_sh;
    for (int i = i0; i < n_qt; ++i) {
      const int q0 = i * kTile;
      const int valid = min(kTile, T - q0);
      __syncthreads();  // the previous Q/dO tile is no longer read
      load_tile<D, LD>(sQ, qg + q0 * p.q_st, p.q_st, valid);
      load_tile<D, LD>(sdO, dog + q0 * p.do_st, p.do_st, valid);
      if (threadIdx.x < kTile) {
        const int c = threadIdx.x;
        sL[c] = c < valid ? p.lse[bh * T + q0 + c] : 0.f;
        sD[c] = c < valid ? p.delta[bh * T + q0 + c] : 0.f;
      }
      __syncthreads();

      const bool need_mask = (kCausal && k0 + kTile - 1 > q0) ||
                             (q0 + kTile > T) || (k0 + kTile > T);
#pragma unroll
      for (int c0 = 0; c0 < kTile; c0 += kSub) {
        // S^T = K . Q^T and dP^T = V . dO^T: 16 keys x 32 queries a warp
        float st[kSub / 8][4], dpt[kSub / 8][4];
#pragma unroll
        for (int nt = 0; nt < kSub / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
        }
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
          uint32_t ak[4], av[4];
          mma_a_from_smem<LD>(ak, sK + (warp * 16) * LD, kc * 16, g, t);
          mma_a_from_smem<LD>(av, sV + (warp * 16) * LD, kc * 16, g, t);
#pragma unroll
          for (int nt = 0; nt < kSub / 8; ++nt) {
            uint32_t b0, b1;
            mma_b_nmajor<LD>(b0, b1, sQ + (c0 + nt * 8) * LD + kc * 16, g, t);
            mma_bf16(st[nt], ak, b0, b1);
            mma_b_nmajor<LD>(b0, b1, sdO + (c0 + nt * 8) * LD + kc * 16, g,
                             t);
            mma_bf16(dpt[nt], av, b0, b1);
          }
        }

        // P^T in st, dS^T in dpt; lse and delta by column
#pragma unroll
        for (int nt = 0; nt < kSub / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + nt * 8 + 2 * t + (e & 1);
            float pv = exp2f(st[nt][e] * p.scale - sL[c]);
            if (need_mask) {
              const int key = krow0 + ((e >> 1) << 3);
              const int query = q0 + c;
              if (query >= T || key >= T || (kCausal && key > query)) {
                pv = 0.f;
              }
            }
            st[nt][e] = pv;
            dpt[nt][e] = pv * (dpt[nt][e] - sD[c]) * p.sm_scale;
          }
        }

        // dv += bf16(P^T) . dO and dk += bf16(dS^T) . Q
#pragma unroll
        for (int kc = 0; kc < kSub / 16; ++kc) {
          uint32_t ap[4], as[4];
          mma_a_from_acc(ap, st[2 * kc], st[2 * kc + 1]);
          mma_a_from_acc(as, dpt[2 * kc], dpt[2 * kc + 1]);
          const int r0 = c0 + kc * 16;
#pragma unroll
          for (int dt = 0; dt < D / 8; ++dt) {
            uint32_t b0, b1;
            mma_b_kmajor<LD>(b0, b1, sdO + r0 * LD + dt * 8, g, t);
            mma_bf16(dv[dt], ap, b0, b1);
            mma_b_kmajor<LD>(b0, b1, sQ + r0 * LD + dt * 8, g, t);
            mma_bf16(dk[dt], as, b0, b1);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = krow0 + 8 * r;
    if (key >= T) continue;
    __nv_bfloat16* ok = p.dk + b * p.dk_sb + kvh * p.dk_sh + key * p.dk_st;
    __nv_bfloat16* ov = p.dv + b * p.dv_sb + kvh * p.dv_sh + key * p.dv_st;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(ok + dt * 8 + 2 * t) =
          pack_f32(dk[dt][2 * r], dk[dt][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(ov + dt * 8 + 2 * t) =
          pack_f32(dv[dt][2 * r], dv[dt][2 * r + 1]);
    }
  }
}

template <int D, bool kCausal, bool kDq>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int LD = D + 8;
  int smem = 4 * kTile * LD * int(sizeof(__nv_bfloat16));
  auto kernel = kDq ? flash_bwd_dq_kernel<D, kCausal>
                    : flash_bwd_dkv_kernel<D, kCausal>;
  if (!kDq) smem += 2 * kTile * int(sizeof(float));  // lse, delta columns
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int heads = kDq ? a.H : a.H / a.groups;
  dim3 grid((a.T + kTile - 1) / kTile, B * heads);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kDq>
int dispatch(const Args& a, int B, int D, int causal, cudaStream_t st) {
  cudaError_t err;
  if (D == 64) {
    err = causal ? launch<64, true, kDq>(a, B, st)
                 : launch<64, false, kDq>(a, B, st);
  } else if (D == 128) {
    err = causal ? launch<128, true, kDq>(a, B, st)
                 : launch<128, false, kDq>(a, B, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return int(err);
}

// s: strides (b, t, head) of q, k, v, dO, then of the outputs
bool fill(Args& a, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, const void* delta, int B, int T,
          int H, int KV, const long long* s, float scale, float sm_scale) {
  if (T < 1 || B < 1 || KV < 1 || H % KV != 0 || lse == nullptr ||
      delta == nullptr) {
    return false;
  }
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = a.dk = a.dv = nullptr;
  a.T = T;
  a.H = H;
  a.groups = H / KV;
  a.q_sb = s[0]; a.q_st = s[1]; a.q_sh = s[2];
  a.k_sb = s[3]; a.k_st = s[4]; a.k_sh = s[5];
  a.v_sb = s[6]; a.v_st = s[7]; a.v_sh = s[8];
  a.do_sb = s[9]; a.do_st = s[10]; a.do_sh = s[11];
  a.scale = scale;
  a.sm_scale = sm_scale;
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
  Args a;
  if (dq == nullptr || !fill(a, q, k, v, dout, lse, delta, B, T, H, KV,
                             strides, scale, sm_scale)) {
    return int(cudaErrorInvalidValue);
  }
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dq_sb = strides[12]; a.dq_st = strides[13]; a.dq_sh = strides[14];
  return dispatch<true>(a, B, D, causal, static_cast<cudaStream_t>(stream));
}

// As flash_bwd_dq_bf16, writing dk/dv [B,T,KV,D] (summed over each KV
// head's query heads) instead of dq. strides: q, k, v, dO, dk, dv.
extern "C" int flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int T,
    int H, int KV, int D, const long long* strides, float scale,
    float sm_scale, int causal, void* stream) {
  Args a;
  if (dk == nullptr || dv == nullptr ||
      !fill(a, q, k, v, dout, lse, delta, B, T, H, KV, strides, scale,
            sm_scale)) {
    return int(cudaErrorInvalidValue);
  }
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.dk_sb = strides[12]; a.dk_st = strides[13]; a.dk_sh = strides[14];
  a.dv_sb = strides[15]; a.dv_st = strides[16]; a.dv_sh = strides[17];
  return dispatch<false>(a, B, D, causal, static_cast<cudaStream_t>(stream));
}
