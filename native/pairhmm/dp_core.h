// Fused pair-HMM DP recursions (ObservationModelFBMaxErr passMessageTwoDec /
// passMessageTwoInc) for one (haplotype, read) pair, shared by the CUDA
// kernel (dp_cuda.cu) and the host build used by the CPU tests (dp_cpu.cc).
//
// The including translation unit defines
//   DP_FN      function qualifiers (__device__ __forceinline__ / inline)
//   DP_SYNC()  barrier between the lanes that share one pair (__syncwarp)
// and compiles with floating-point contraction OFF (nvcc -fmad=false,
// g++ -ffp-contract=off): every sum below is evaluated in exactly the
// association of hmm/batch._dp_xla.  The one multiply-add, lpe +
// (y-1)*logpInsgIns, rounds once either way: logpInsgIns is -0.5, so the
// product is exact and an FMA and a multiply-then-add agree.
//
// Semantics are those of _dp_xla, state for state: the same candidate
// folds in the same order with the same (value, source index) updateMax
// rule, so values and backpointers are bit-identical.  The differences
// are in what is computed and stored:
//   - each pair runs its forward pass only up to its own b_mid and its
//     backward pass only down to it (the slices _finish consumes);
//   - backpointers are stored as one byte per state: the 4-bit transition
//     class of the noins state (low nibble) and of the ins state (high
//     nibble), decoded by _finish(bt_codes=True) / hmm.fused.expand_bt_codes.
//     Forward rows >= b_mid are not written; backward rows below b_mid are
//     not written, rows from read_len-1 up hold the padded-slice code.
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define DP_HOSTDEV __host__ __device__
#else
#define DP_HOSTDEV
#endif

namespace dindel_dp {

constexpr float kNegBig = -1.0e30f;
constexpr float kEps = 1e-10f;  // reference EPS (ObservationModelFB.hpp:25)
constexpr float kTie = 1e-5f;   // updateMax tie band (ObservationModelFB.cpp:883)
constexpr uint8_t kCodeN = 'N';

struct Dims {
  int64_t B;     // pairs
  int H;         // H_pad
  int L;         // L_pad
  int S;         // S_half = H_pad + 2
  int numT;      // maxLengthDel + 2 (<= 15)
};

struct Scal {
  float LOgLO, FirstgLO, InsgIns, NoInsgIns, NoInsgNoIns;
};

// Per-pair shared scratch, in floats: an, ai, wn, wi, lpe, lpn (S each),
// eq, uq (L each); in bytes: read codes (L), hap codes (H).
inline DP_HOSTDEV int64_t scratch_floats(const Dims& d) {
  return 6 * (int64_t)d.S + 2 * d.L;
}
inline DP_HOSTDEV int64_t scratch_bytes(const Dims& d) {
  return (int64_t)d.L + d.H;
}

// One updateMax step (ObservationModelFB.cpp:877-888): take a candidate
// that beats the running max by more than EPS, or ties it within TIE
// with a lower source index.
DP_FN void fold(float& dv, int& di, float cv, int ci) {
  const bool take = cv > dv + kEps;
  const bool tie = (cv >= dv) && (cv <= dv + kTie) && (di > ci);
  if (take || tie) {
    dv = cv;
    di = ci;
  }
}

// lpe + k * logpInsgIns, the insertion-extension cost of a k+1 deletion
// jump.
DP_FN float ext_cost(float lpe, int k, float c) { return lpe + (float)k * c; }

// Observation potentials of read base t: noins state x (1..H) on hap base
// x-1; states 0, RO and every ins state take e.
DP_FN void obs_phase(const Dims& d, int lane, int nl, int t, const float* an,
                     const float* ai, float* wn, float* wi, const float* eq,
                     const float* uq, const uint8_t* rc, const uint8_t* hc) {
  const uint8_t rb = rc[t];
  const float e = eq[t], u = uq[t];
  for (int x = lane; x < d.S; x += nl) {
    float on = e;
    if (x >= 1 && x <= d.H) {
      const uint8_t h = hc[x - 1];
      if (h != rb && h != kCodeN) on = u;
    }
    wn[x] = an[x] + on;
    wi[x] = ai[x] + e;
  }
}

// Forward (Dec) slice: new alpha at every state from W = alpha + obs.
DP_FN void dec_phase(const Dims& d, const Scal& s, int lane, int nl,
                     int hl, float* an, float* ai, const float* wn,
                     const float* wi, const float* lpe, const float* lpn,
                     uint8_t* bt_row) {
  const int S = d.S, RO = d.H + 1;
  for (int x = lane; x < S; x += nl) {
    float nv, iv;
    int ni, ii;
    if (x == 0) {
      nv = wn[0] + s.NoInsgNoIns;
      ni = 0;
    } else if (x == RO) {
      nv = kNegBig;
      ni = RO;
      fold(nv, ni, (wn[RO] + s.LOgLO) + s.NoInsgNoIns, RO);
      fold(nv, ni, (wn[hl] + s.FirstgLO) + s.NoInsgNoIns, hl);
      fold(nv, ni, (wi[RO] + s.LOgLO) + lpe[RO], S + RO);
      fold(nv, ni, (wi[hl] + s.FirstgLO) + lpe[hl], S + hl);
    } else {
      nv = kNegBig;
      ni = x;
      const float lpe_x = lpe[x], lpn_x = lpn[x];
      for (int y = 1; y < d.numT; ++y) {
        const int src = x - y > 0 ? x - y : 0;
        const float lp = y == 1 ? lpn_x : ext_cost(lpe_x, y - 1, s.InsgIns);
        fold(nv, ni, (wn[src] + lp) + lpn_x, src);
      }
      const int src = x - 1 > 0 ? x - 1 : 0;
      fold(nv, ni, wi[src] + lpe_x, S + src);
    }
    iv = wi[x] + s.InsgIns;
    ii = S + x;
    if (x >= 1)
      fold(iv, ii, wn[x] + s.NoInsgIns, x);
    else
      fold(iv, ii, kNegBig, ii);
    if (!(x <= hl || x == RO)) {
      nv = kNegBig;
      ni = x;
      iv = kNegBig;
      ii = S + x;
    }
    an[x] = nv;
    ai[x] = iv;
    // transition classes (decode tables: hmm.fused.expand_bt_codes)
    int cn;
    if (x == RO)
      cn = ni == RO ? 2 : ni == hl ? 3 : ni == S + RO ? 0 : 1;
    else
      cn = ni >= S ? 0 : ni == x ? 1 : 1 + (x - ni);
    const int ci = ii >= S ? 0 : 1;
    bt_row[x] = (uint8_t)(cn | (ci << 4));
  }
}

// Backward (Inc) slice: new beta at every state from W = beta + obs.
// Sources beyond the pair's hap end clamp to RO (the _dp_xla V-arrays).
DP_FN void inc_phase(const Dims& d, const Scal& s, int lane, int nl,
                     int hl, float* an, float* ai, const float* wn,
                     const float* wi, const float* lpe, const float* lpn,
                     uint8_t* bt_row) {
  const int S = d.S, RO = d.H + 1, numT = d.numT;
  const float wro = wn[RO], lpe_ro = lpe[RO], lpn_ro = lpn[RO];
  for (int x = lane; x < S; x += nl) {
    float nv, iv;
    int ni, ii;
    if (x == 0) {
      nv = kNegBig;
      ni = 0;
      fold(nv, ni, (wn[0] + s.LOgLO) + s.NoInsgNoIns, 0);
      fold(nv, ni, (wn[1] + s.FirstgLO) + s.NoInsgNoIns, 1);
      fold(nv, ni, wi[0] + lpe[1], S);
    } else if (x == RO) {
      nv = kNegBig;
      ni = RO;
      fold(nv, ni, wn[RO] + lpn[RO], RO);
      fold(nv, ni, wi[RO] + 0.0f, S + RO);
    } else {
      nv = kNegBig;
      ni = x;
      for (int y = 1; y < numT; ++y) {
        const int j = x + y;
        const bool in = j <= hl;
        const float sw = in ? wn[j] : wro;
        const float sn = in ? lpn[j] : lpn_ro;
        const float lp = y == 1 ? sn
                                : ext_cost(in ? lpe[j] : lpe_ro, y - 1,
                                           s.InsgIns);
        fold(nv, ni, (lp + sn) + sw, in ? j : RO);
      }
      fold(nv, ni, wi[x] + lpe[x + 1], S + x);
    }
    iv = wi[x] + s.InsgIns;
    ii = S + x;
    if (x == 0) {
      fold(iv, ii, wn[0] + s.NoInsgIns, 0);
    } else {
      const int j = x + 1;
      const bool in = j <= hl;
      fold(iv, ii, (in ? wn[j] : wro) + s.NoInsgIns, in ? j : RO);
    }
    if (!(x <= hl || x == RO)) {
      nv = kNegBig;
      ni = x;
      iv = kNegBig;
      ii = S + x;
    }
    an[x] = nv;
    ai[x] = iv;
    int cn;
    if (ni == S + x)
      cn = 0;
    else if (ni == x)
      cn = numT;
    else if (ni == RO)
      cn = numT - (hl + 1 - x > 1 ? hl + 1 - x : 1);
    else
      cn = numT - (ni - x);
    const int ci = ii == S + x ? 0 : (x == 0 ? 1 : 2);
    bt_row[x] = (uint8_t)(cn | (ci << 4));
  }
}

// The whole DP of pair p, run by `nl` cooperating lanes (lane = 0..nl-1)
// that share the scratch `sm` / `smb`.
DP_FN void pair_dp(const Dims& d, const Scal& s, int lane, int nl,
                   int64_t p, const int32_t* hap_len, const int32_t* read_len,
                   const int32_t* b_mid, const uint8_t* rc_g,
                   const uint8_t* hc_g, const float* eq_g, const float* uq_g,
                   const float* lpe_g, const float* lpn_g, float* amid,
                   float* bmid, uint8_t* btf, uint8_t* btb, float* sm,
                   uint8_t* smb) {
  const int S = d.S, L = d.L;
  float* an = sm;
  float* ai = sm + S;
  float* wn = sm + 2 * S;
  float* wi = sm + 3 * S;
  float* lpe = sm + 4 * S;
  float* lpn = sm + 5 * S;
  float* eq = sm + 6 * S;
  float* uq = sm + 6 * S + L;
  uint8_t* rc = smb;
  uint8_t* hc = smb + L;
  const int hl = hap_len[p], rl = read_len[p], bm = b_mid[p];
  const int64_t row = (int64_t)d.B * S;  // bt stride between slices

  for (int x = lane; x < S; x += nl) {
    lpe[x] = lpe_g[p * S + x];
    lpn[x] = lpn_g[p * S + x];
    an[x] = 0.0f;
    ai[x] = 0.0f;
  }
  for (int t = lane; t < L; t += nl) {
    eq[t] = eq_g[p * L + t];
    uq[t] = uq_g[p * L + t];
    rc[t] = rc_g[p * L + t];
  }
  for (int t = lane; t < d.H; t += nl) hc[t] = hc_g[p * d.H + t];
  DP_SYNC();

  // forward: alpha slices 1..b_mid; btf row b-1 holds slice b
  for (int b = 1; b <= bm; ++b) {
    obs_phase(d, lane, nl, b - 1, an, ai, wn, wi, eq, uq, rc, hc);
    DP_SYNC();
    dec_phase(d, s, lane, nl, hl, an, ai, wn, wi, lpe, lpn,
              btf + (b - 1) * row + p * S);
    DP_SYNC();
  }
  for (int x = lane; x < S; x += nl) {
    amid[p * 2 * S + x] = an[x];
    amid[p * 2 * S + S + x] = ai[x];
    an[x] = 0.0f;
    ai[x] = 0.0f;
  }
  // backward: slices from read_len-1 up are the padded zero; beta slices
  // read_len-2 .. b_mid; btb row b-1 holds slice b-1
  for (int b = rl - 1; b >= bm + 1; --b) {
    obs_phase(d, lane, nl, b, an, ai, wn, wi, eq, uq, rc, hc);
    DP_SYNC();
    inc_phase(d, s, lane, nl, hl, an, ai, wn, wi, lpe, lpn,
              btb + (b - 1) * row + p * S);
    DP_SYNC();
  }
  const int r0 = rl - 1 > 0 ? rl - 1 : 0;
  for (int x = lane; x < S; x += nl) {
    bmid[p * 2 * S + x] = an[x];
    bmid[p * 2 * S + S + x] = ai[x];
    for (int r = r0; r < L - 1; ++r) btb[r * row + p * S + x] = (uint8_t)d.numT;
  }
  DP_SYNC();
}

}  // namespace dindel_dp
