// The f32 BPTTs' gate phases, shared by the cluster kernels that take a
// Cell policy (wide_f32_common.cuh: bilstm_bwd_wide_f32.cu,
// bigru_bwd_wide_f32.cu; narrow_f32_common.cuh: bilstm_bwd_narrow_f32.cu,
// bigru_bwd_narrow_f32.cu). A Cell gives kGates and kExtra; an Op, the operands of one
// (row, unit) pair, which load() fetches a step ahead (into registers) and
// which carries the pair's own carry (the LSTM's dc, the GRU's dh·z);
// carry0(), the carry that the dh partials are added to; grads(), which
// turns the recomputed gate sums z and the carry into the pair's dgates d
// (the chained product's operands) and x, what it stores beside them (the
// GRU's dn_pre); store(), which writes them to dgx (and dnr); and step(),
// both, the store when ok.
//
// The f32 forwards' cells (narrow_f32_fwd.cuh: bilstm_fwd_narrow_f32.cu,
// bigru_fwd_narrow_f32.cu) take the same shape: an Op holds a (row, unit)
// pair's input gates, loaded a step ahead, and its f32 carry (the LSTM's c,
// the GRU's h, beside its b_hn); step() turns the gate sums z = h · W_h into
// the pair's new h; store() writes y (and the LSTM's c when asked).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "lstm_common.cuh"

namespace percival {

// The LSTM's gate phase: a (row, unit) pair's operands, its dz and its dc
// carry.
struct F32LstmCell {
  static constexpr int kGates = 4;
  static constexpr int kExtra = 0;  // values a pair stores beside its dgates
  const float* gx;
  const float* cp;
  const float* cs;
  const float* dy;
  float* dgx;
  int B, H;

  struct Op {
    float gx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float c = 0.0f, cp = 0.0f, dy = 0.0f;
    float dc = 0.0f;  // dc_carry
  };

  __device__ __forceinline__ void load(Op& o, int t, int row, int unit, bool ok) const {
    const size_t base = (size_t)t * B + row;
#pragma unroll
    for (int g = 0; g < 4; ++g) o.gx[g] = ok ? gx[base * 4 * H + g * H + unit] : 0.0f;
    o.c = ok ? cs[base * H + unit] : 0.0f;
    o.cp = ok ? cp[base * H + unit] : 0.0f;
    o.dy = ok ? dy[base * H + unit] : 0.0f;
  }
  __device__ __forceinline__ float carry0(const Op&) const { return 0.0f; }
  // the pair's dz (x: nothing the LSTM stores beyond dz), its dc carry
  __device__ __forceinline__ void grads(Op& o, const float (&z)[4], float carry, float (&d)[4],
                                        float& x, bool ok) const {
    const float ig = sigmoid_f32(o.gx[0] + z[0]);
    const float fg = sigmoid_f32(o.gx[1] + z[1]);
    const float gg = tanhf(o.gx[2] + z[2]);
    const float og = sigmoid_f32(o.gx[3] + z[3]);
    const float tc = tanhf(o.c);
    const float dh = o.dy + carry;
    const float dc = o.dc + dh * og * (1.0f - tc * tc);
    d[0] = dc * gg * ig * (1.0f - ig);
    d[1] = dc * o.cp * fg * (1.0f - fg);
    d[2] = dc * ig * (1.0f - gg * gg);
    d[3] = dh * tc * og * (1.0f - og);
    x = 0.0f;
    o.dc = ok ? dc * fg : 0.0f;
  }
  // dgx[t][row] of the unit: its four gates' d[g], read at d[g·ds]
  __device__ __forceinline__ void store(const float* d, int ds, float, int t, int row,
                                        int unit) const {
    float* out = dgx + ((size_t)t * B + row) * 4 * H + unit;
#pragma unroll
    for (int g = 0; g < 4; ++g) out[g * H] = d[g * ds];
  }
  __device__ __forceinline__ void step(Op& o, const float (&z)[4], float carry, float (&d)[4],
                                       int t, int row, int unit, bool ok) const {
    float x;
    grads(o, z, carry, d, x, ok);
    if (ok) store(d, 1, x, t, row, unit);
  }
};

// The GRU's gate phase: a (row, unit) pair's operands, its dgates and its
// dh·z, the carry's direct path.
struct F32GruCell {
  static constexpr int kGates = 3;
  static constexpr int kExtra = 1;  // dn_pre
  const float* gx;
  const float* bn;
  const float* hp;
  const float* dy;
  float* dgx;
  float* dnr;
  int B, H;

  struct Op {
    float gx[3] = {0.0f, 0.0f, 0.0f};
    float hp = 0.0f, dy = 0.0f, bias = 0.0f;
    float dhz = 0.0f;  // dh·z of the previous step
  };

  __device__ __forceinline__ void load(Op& o, int t, int row, int unit, bool ok) const {
    const size_t base = (size_t)t * B + row;
#pragma unroll
    for (int g = 0; g < 3; ++g) o.gx[g] = ok ? gx[base * 3 * H + g * H + unit] : 0.0f;
    o.hp = ok ? hp[base * H + unit] : 0.0f;
    o.dy = ok ? dy[base * H + unit] : 0.0f;
    o.bias = ok ? bn[unit] : 0.0f;
  }
  __device__ __forceinline__ float carry0(const Op& o) const { return o.dhz; }
  // the pair's chained dgates d = (dr_pre, dz_pre, dnr), x = dn_pre, its dh·z
  __device__ __forceinline__ void grads(Op& o, const float (&gh)[3], float carry, float (&d)[3],
                                        float& x, bool ok) const {
    const float rg = sigmoid_f32(o.gx[0] + gh[0]);
    const float zg = sigmoid_f32(o.gx[1] + gh[1]);
    const float ghn = gh[2] + o.bias;
    const float ng = tanhf(o.gx[2] + rg * ghn);
    const float dh = o.dy + carry;
    const float dn_pre = dh * (1.0f - zg) * (1.0f - ng * ng);
    d[0] = dn_pre * ghn * rg * (1.0f - rg);
    d[1] = dh * (o.hp - ng) * zg * (1.0f - zg);
    d[2] = dn_pre * rg;  // dnr: the chained product's n column
    x = dn_pre;
    o.dhz = ok ? dh * zg : 0.0f;
  }
  // dgx[t][row] of the unit (dr_pre, dz_pre, x = dn_pre) and dnr, from the
  // chained dgates read at d[g·ds]
  __device__ __forceinline__ void store(const float* d, int ds, float x, int t, int row,
                                        int unit) const {
    const size_t base = (size_t)t * B + row;
    float* out = dgx + base * 3 * H + unit;
    out[0] = d[0];
    out[H] = d[ds];
    out[2 * H] = x;
    dnr[base * H + unit] = d[2 * ds];
  }
  __device__ __forceinline__ void step(Op& o, const float (&gh)[3], float carry, float (&d)[3],
                                       int t, int row, int unit, bool ok) const {
    float x;
    grads(o, gh, carry, d, x, ok);
    if (ok) store(d, 1, x, t, row, unit);
  }
};

// The LSTM forward's gate phase (bilstm_fwd.cu's math): z = gx + h·W_h,
// c = f·c + i·g, h = o·tanh(c), both carried in f32.
struct F32LstmFwdCell {
  static constexpr int kGates = 4;
  const float* gx;
  float* y;
  float* cs;  // null: the cells are not wanted
  int B, H;

  struct Op {
    float gx[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float c = 0.0f;
  };

  __device__ __forceinline__ void init(Op&, int) const {}
  __device__ __forceinline__ void load(Op& o, int t, int row, int unit, bool ok) const {
    const size_t base = ((size_t)t * B + row) * 4 * H + unit;
#pragma unroll
    for (int g = 0; g < 4; ++g) o.gx[g] = ok ? gx[base + g * H] : 0.0f;
  }
  __device__ __forceinline__ float step(Op& o, const float (&z)[4]) const {
    const float ig = sigmoid_f32(o.gx[0] + z[0]);
    const float fg = sigmoid_f32(o.gx[1] + z[1]);
    const float gg = tanhf(o.gx[2] + z[2]);
    const float og = sigmoid_f32(o.gx[3] + z[3]);
    o.c = fg * o.c + ig * gg;
    return og * tanhf(o.c);
  }
  __device__ __forceinline__ void store(const Op& o, int t, int row, int unit, float h) const {
    const size_t off = ((size_t)t * B + row) * H + unit;
    y[off] = h;
    if (cs != nullptr) cs[off] = o.c;
  }
};

// The GRU forward's gate phase (bigru_fwd.cu's math): r = σ(gx_r + gh_r),
// z = σ(gx_z + gh_z), n = tanh(gx_n + r·(gh_n + b_hn)), h = (1 − z)·n + z·h,
// h carried in f32.
struct F32GruFwdCell {
  static constexpr int kGates = 3;
  const float* gx;
  const float* bn;
  float* y;
  int B, H;

  struct Op {
    float gx[3] = {0.0f, 0.0f, 0.0f};
    float h = 0.0f, bias = 0.0f;
  };

  __device__ __forceinline__ void init(Op& o, int unit) const { o.bias = bn[unit]; }
  __device__ __forceinline__ void load(Op& o, int t, int row, int unit, bool ok) const {
    const size_t base = ((size_t)t * B + row) * 3 * H + unit;
#pragma unroll
    for (int g = 0; g < 3; ++g) o.gx[g] = ok ? gx[base + g * H] : 0.0f;
  }
  __device__ __forceinline__ float step(Op& o, const float (&gh)[3]) const {
    const float rg = sigmoid_f32(o.gx[0] + gh[0]);
    const float zg = sigmoid_f32(o.gx[1] + gh[1]);
    const float ng = tanhf(o.gx[2] + rg * (gh[2] + o.bias));
    o.h = (1.0f - zg) * ng + zg * o.h;
    return o.h;
  }
  __device__ __forceinline__ void store(const Op&, int t, int row, int unit, float h) const {
    y[((size_t)t * B + row) * H + unit] = h;
  }
};

}  // namespace percival
