// Kernel L: flatten's per-slot tables.
//
// Replaces no Pallas kernel: jello_tpu leaves flatten's per-slot chain to
// XLA (pipeline/flatten.py: decode_tag_stream, _read_points,
// _normalize_segment, the style and transform reads, slot_geometry and
// the tables flatten_stage builds from them). The port ran it as ~880
// torch ops over vectors of N tag slots, each a full pass over N, and then
// assembled the tables with strided stacks of 15 to 21 columns.
//
// The contract (pipeline/flatten.py::slot_tables_plain, which stays the
// specification): for each of the N slots, its tag byte and its
// successor's, from the stage's decoded tag stream (decode_tag_stream's
// [Ne] i32, which the tag monoid also scans); its segment's points read and
// normalized (cap-marker remap, degree raise), as its successor's; its
// style words and transform; the stroke geometry of slot_geometry (offset
// frames, caps, joins, miter spikes, round-join and cap arcs) and the draw
// flags. Outputs, each row where its consumer reads it:
//   tab2 [2N, 21] f32: the Euler work row of pass A at slot s, of pass B
//     at N + s;
//   counts2 [2N] i32: act_a, then act_b;
//   sa [4N, 15] f32: the simple-line rows of the three families at k N + s
//     (ends transformed, ten zero columns, the path), the arc row at 3N + s;
//   orow [N, 3] i32: the running simple-line counts o1, o2, o3;
//   tot4 [N] i32: o3 plus the arc's line count;
//   tgt [N] i32 and pmeta [N, 2] i32: the path a path-marker slot sets
//     (n_paths_cap elsewhere) and its (draw flags, transform index);
//   arc_n [N] f32: the arc's line count.
// The successor: with Ne == N decoded slots, slot N - 1's is slot 0 (the
// whole tag stream); with Ne > N (a tag-range shard of cuda/sharded2.py,
// which decodes four slots past its own), slot i's is decoded slot i + 1.
// A scene word index out of the scene is clamped to it, as
// ops.gather_guarded clamps it.
//
// Exactness: every expression below is the torch expression it stands
// for, one IEEE operation each, built with -fmad=false so no product and
// sum contract; Python's float constants are cast to float once (F(x)),
// as torch casts a scalar operand; the transcendentals are pmath.cuh's;
// the torch.where selects are selects (a value computed on the branch not
// taken is not computed here, which changes nothing); torch.clamp keeps a
// NaN (pm::clamp*). The tables equal the plain version's bit for bit.
//
// What bounds it on an H100: bytes. A slot reads ~80 bytes (its monoid
// words, its decoded tag, its style words, its points, its
// transform, the last two mostly shared with its neighbours) and writes
// 448 (two 21-float rows, four 15-float rows and 28 bytes of counts), so
// ~0.1 ms for the ~600,000 slots of a large sprite scene. The design is
// one pass, one slot a thread. The successor's tag and start tangent come
// from its thread through shared memory (the block's last slot decodes
// one more, its halo), not from a second gather. Each warp stages its 32
// rows of a table in shared memory and stores them as one contiguous run,
// as kernel J does: a thread storing its own 84-byte row would make each
// store of a warp touch 32 scattered sectors.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flatten_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kEulerCols = 21;  // tab2's columns (slot_geometry's tabA, tabB)
constexpr int kSaCols = 15;     // the simple/arc table's
constexpr int kStage = 32 * kEulerCols;

// encoding/path.py
constexpr int kTagSegTypeMask = 0x3;
constexpr int kTagSubpathEnd = 0x4;
constexpr int kTagF32 = 0x8;
constexpr int kTagPath = 0x10;
constexpr int kSegLine = 1;
constexpr int kSegQuad = 2;
constexpr uint32_t kStyleBit = 0x80000000u;
constexpr uint32_t kFillBit = 0x40000000u;
constexpr uint32_t kJoinMask = 0x30000000u;
constexpr uint32_t kJoinBevel = 0;
constexpr uint32_t kJoinMiter = 0x10000000u;
constexpr uint32_t kJoinRound = 0x20000000u;
constexpr uint32_t kCapSquare = 0x01000000u;
constexpr uint32_t kCapRound = 0x02000000u;
constexpr uint32_t kStartCapMask = 0x0C000000u;
constexpr uint32_t kEndCapMask = 0x03000000u;
constexpr uint32_t kMiterLimitMask = 0xFFFFu;

struct Inputs {
  const int* scene;
  long long S;  // scene words
  // the decoded tag bytes [Ne], one i32 a slot
  const int* tags;
  // 0-dim layout fields, read on the device (a frame's layout is data)
  const int* path_data_base;
  const int* style_base;
  const int* transform_base;
  const int* n_path_tags;
  // the tag monoid's exclusive columns [Ne], each `ms` words apart
  const int* path_idx;
  const int* seg_off;
  const int* style_idx;
  const int* trans_idx;
  long long ms;
  int N, Ne, tag_lo, n_paths_cap;
};

// Slot j of a monoid column.
__device__ __forceinline__ int col(const Inputs& in, const int* c, int j) {
  return __ldg(c + j * in.ms);
}

// ops.gather_guarded: the word at idx, idx clamped to the scene. The
// index sums wrap as the torch int32 sums do.
__device__ __forceinline__ int word(const Inputs& in, int idx) {
  const long long i = idx < 0 ? 0 : (idx >= in.S ? in.S - 1 : idx);
  return __ldg(in.scene + i);
}

__device__ __forceinline__ int wsum(int a, int b) { return (int)((unsigned)a + (unsigned)b); }

// A slot as the stage reads it: its tag, the style flags, _read_points and
// _normalize_segment.
struct Seg {
  int tag;
  uint32_t style;
  bool is_stroke, is_marker, is_open;
  int seg_type0;
  fm::Cubic P;
};

__device__ __forceinline__ Seg load_seg(const Inputs& in, int j, int pdb, int sb) {
  Seg s;
  s.tag = __ldg(in.tags + j);
  s.style = (uint32_t)word(in, wsum(sb, col(in, in.style_idx, j) - 2));
  s.is_stroke = (s.style & kStyleBit) != 0;
  const int base = wsum(pdb, col(in, in.seg_off, j));
  s.seg_type0 = s.tag & kTagSegTypeMask;
  float p[8];
  if (s.tag & kTagF32) {
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k] = __int_as_float(word(in, wsum(base, k)));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int v = word(in, wsum(base, k));
      p[2 * k] = (float)((int)((unsigned)v << 16) >> 16);
      p[2 * k + 1] = (float)(v >> 16);
    }
  }
  s.is_marker = s.is_stroke && (s.tag & kTagSubpathEnd) != 0;
  s.is_open = s.seg_type0 == kSegQuad;
  int seg_type = s.seg_type0;
  if (s.is_marker && s.is_open) {
    p[0] = p[2];
    p[1] = p[3];
    p[2] = p[4];
    p[3] = p[5];
    seg_type = kSegLine;
  }
  const float third = F(1.0 / 3.0);
  float* P = s.P.p;
  P[0] = p[0];
  P[1] = p[1];
  if (seg_type == kSegLine) {
    P[2] = p[0] + (p[2] - p[0]) * third;
    P[3] = p[1] + (p[3] - p[1]) * third;
    P[4] = p[2] + (p[0] - p[2]) * third;
    P[5] = p[3] + (p[1] - p[3]) * third;
    P[6] = p[2];
    P[7] = p[3];
  } else if (seg_type == kSegQuad) {
    P[2] = p[2] + (p[0] - p[2]) * third;
    P[3] = p[3] + (p[1] - p[3]) * third;
    P[4] = p[2] + (p[4] - p[2]) * third;
    P[5] = p[3] + (p[5] - p[3]) * third;
    P[6] = p[4];
    P[7] = p[5];
  } else {
#pragma unroll
    for (int k = 2; k < 8; ++k) P[k] = p[k];
  }
  return s;
}

// _fix_tangent
__device__ __forceinline__ void fix_tangent(float* tx, float* ty) {
  if (*tx * *tx + *ty * *ty < F(fm::kTangentThresh * fm::kTangentThresh)) {
    *tx = F(fm::kTangentThresh);
    *ty = 0.0f;
  }
}

// _normalize_vec
__device__ __forceinline__ void normalize(float vx, float vy, float* ox, float* oy) {
  const float ln = sqrtf(vx * vx + vy * vy);
  *ox = vx / ln;
  *oy = vy / ln;
}

// apply_transform
__device__ __forceinline__ void xform(const float* T, float x, float y, float* ox, float* oy) {
  *ox = T[0] * x + T[2] * y + T[4];
  *oy = T[1] * x + T[3] * y + T[5];
}

// What a slot's predecessor reads of it: its tag and its start tangent
// (cubic_start_tangent, then _fix_tangent), into entry e.
__device__ __forceinline__ void share_start(const Seg& g, int e, int* s_tag, float* s_tsx,
                                            float* s_tsy) {
  float tx, ty;
  fm::cubic_start_tangent(g.P, &tx, &ty);
  fix_tangent(&tx, &ty);
  s_tag[e] = g.tag;
  s_tsx[e] = tx;
  s_tsy[e] = ty;
}

// A warp's `rows` rows of `width` words, staged row by row in s, stored
// to out as one contiguous run.
__device__ __forceinline__ void store_rows(const uint32_t* s, uint32_t* __restrict__ out,
                                           int rows, int width, int lane) {
  __syncwarp();
  for (int k = lane; k < rows * width; k += 32) out[k] = s[k];
  __syncwarp();
}

__device__ __forceinline__ void stage_floats(uint32_t* s, const float* v, int n) {
  for (int c = 0; c < n; ++c) s[c] = __float_as_uint(v[c]);
}

__global__ void __launch_bounds__(kThreads)
slot_tables_kernel(Inputs in, float* __restrict__ tab2, int* __restrict__ counts2,
                   float* __restrict__ sa, int* __restrict__ orow, int* __restrict__ tot4,
                   int* __restrict__ tgt, int* __restrict__ pmeta, float* __restrict__ arc_n_out) {
  __shared__ int s_tag[kThreads + 1];
  __shared__ float s_tsx[kThreads + 1], s_tsy[kThreads + 1];
  __shared__ uint32_t s_rows[kThreads / 32][kStage];

  const int N = in.N;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int b0 = blockIdx.x * kThreads;
  const int i = b0 + t;
  const int row0 = b0 + (t & ~31);  // the warp's first slot
  const int rows = min(32, N - row0);
  const int pdb = __ldg(in.path_data_base);
  const int sb = __ldg(in.style_base), tb = __ldg(in.transform_base);
  const bool live = i < N;

  Seg g;
  if (live) {
    g = load_seg(in, i, pdb, sb);
    share_start(g, t, s_tag, s_tsx, s_tsy);
    // The block's last slot also decodes its successor, into the next entry.
    if (i == min(b0 + kThreads, N) - 1) {
      const int j = in.Ne == N ? (i + 1 == N ? 0 : i + 1) : i + 1;
      share_start(load_seg(in, j, pdb, sb), t + 1, s_tag, s_tsx, s_tsy);
    }
  }
  __syncthreads();

  float tabA[kEulerCols], tabB[kEulerCols], s_l[3][4], arc[8], T[6];
  bool s_valid[3];
  float arc_nv = 0.0f;
  int act_a = 0, act_b = 0, tgt_v = 0, df = 0, trans = 0;
  if (live) {
    const float* P = g.P.p;
    const int tag_next = s_tag[t + 1];
    const float tan_nx = s_tsx[t + 1], tan_ny = s_tsy[t + 1];
    const float tan_sx = s_tsx[t], tan_sy = s_tsy[t];
    const bool active = wsum(i, in.tag_lo) < __ldg(in.n_path_tags);
    const int path_idx = col(in, in.path_idx, i);
    trans = col(in, in.trans_idx, i) - 1;
    const uint32_t sf = g.style;
    const float linewidth =
        __int_as_float(word(in, wsum(wsum(sb, col(in, in.style_idx, i) - 2), 1)));
    const int tbase = wsum(tb, (int)((unsigned)trans * 6u));
#pragma unroll
    for (int k = 0; k < 6; ++k) T[k] = __int_as_float(word(in, wsum(tbase, k)));
    const float miter_limit =
        __half2float(__ushort_as_half((unsigned short)(sf & kMiterLimitMask)));
    const bool is_stroke = g.is_stroke;
    const bool marker = active && (g.tag & kTagPath) != 0;
    tgt_v = marker ? path_idx : in.n_paths_cap;
    df = (sf & kFillBit) == 0 ? 0 : 1;

    // slot_geometry
    const bool seg_mask = active && g.seg_type0 != 0;
    const float offset = 0.5f * linewidth;
    const float v1x = T[0] + T[3], v1y = T[1] - T[2];
    const float v2x = T[0] - T[3], v2y = T[1] + T[2];
    const float stroke_scale =
        0.5f * sqrtf(v1x * v1x + v1y * v1y) + sqrtf(v2x * v2x + v2y * v2y);
    const float scale = is_stroke ? stroke_scale : 1.0f;
    float PD[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) xform(T, P[2 * k], P[2 * k + 1], &PD[2 * k], &PD[2 * k + 1]);

    float tan_px, tan_py;
    fm::cubic_end_tangent(g.P, &tan_px, &tan_py);
    fix_tangent(&tan_px, &tan_py);

    float nsx, nsy, otx, oty, nnxn, nnyn;
    normalize(-tan_sy, tan_sx, &nsx, &nsy);
    nsx = nsx * offset;
    nsy = nsy * offset;
    normalize(tan_px, tan_py, &otx, &oty);
    otx = otx * offset;
    oty = oty * offset;
    const float npx = -oty, npy = otx;
    normalize(tan_nx, tan_ny, &nnxn, &nnyn);
    const float nnx = -nnyn * offset, nny = nnxn * offset;

    const bool next_is_marker = (tag_next & kTagSubpathEnd) != 0;
    const bool next_is_closed = (tag_next & kTagSegTypeMask) == kSegLine;
    const bool do_join = !next_is_marker || next_is_closed;
    const bool regular = seg_mask && is_stroke && !g.is_marker;
    const bool start_cap_slot = seg_mask && is_stroke && g.is_marker && g.is_open;

    act_a = seg_mask && (!is_stroke || regular);
    act_b = regular;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      tabA[k] = is_stroke ? P[k] : PD[k];
      tabB[k] = P[k];
    }
    tabA[8] = is_stroke ? offset : 0.0f;
    tabA[9] = scale;
    tabA[10] = is_stroke ? P[0] + nsx : PD[0];
    tabA[11] = is_stroke ? P[1] + nsy : PD[1];
    tabA[12] = is_stroke ? P[6] + npx : PD[6];
    tabA[13] = is_stroke ? P[7] + npy : PD[7];
    tabB[8] = -offset;
    tabB[9] = scale;
    tabB[10] = P[0] - nsx;
    tabB[11] = P[1] - nsy;
    tabB[12] = P[6] - npx;
    tabB[13] = P[7] - npy;
    const float ident[6] = {1.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f};
    const float fpath = (float)path_idx;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      tabA[14 + k] = is_stroke ? T[k] : ident[k];
      tabB[14 + k] = T[k];
    }
    tabA[20] = fpath;
    tabB[20] = fpath;

    const float p3x = P[6], p3y = P[7], p0x = P[0], p0y = P[1];
    const uint32_t join_kind = sf & kJoinMask;
    const float cr = tan_px * tan_ny - tan_py * tan_nx;
    const float dd = tan_px * tan_nx + tan_py * tan_ny;
    float front0x = p3x + npx, front0y = p3y + npy;
    const float front1x = p3x + nnx, front1y = p3y + nny;
    const float back0x = p3x - nnx, back0y = p3y - nny;
    const float back1x = p3x - npx, back1y = p3y - npy;

    const float hyp = sqrtf(cr * cr + dd * dd);
    const bool miter_cond = (2.0f * hyp < (hyp + dd) * miter_limit * miter_limit) && cr != 0.0f;
    const bool is_backside = cr > 0.0f;
    const float fp_last_x = is_backside ? back1x : front0x;
    const float fp_last_y = is_backside ? back1y : front0y;
    const float fp_this_x = is_backside ? back0x : front1x;
    const float fp_this_y = is_backside ? back0y : front1y;
    const float p_mx = is_backside ? back0x : front0x;
    const float p_my = is_backside ? back0y : front0y;
    const float vx_m = fp_this_x - fp_last_x;
    const float vy_m = fp_this_y - fp_last_y;
    const float safe_cr = cr == 0.0f ? 1.0f : cr;
    const float h_m = (tan_px * vy_m - tan_py * vx_m) / safe_cr;
    const float miter_px = fp_this_x - tan_nx * h_m;
    const float miter_py = fp_this_y - tan_ny * h_m;
    const bool is_miter = join_kind == kJoinMiter;
    const bool apply_miter = is_miter && miter_cond;
    if (apply_miter && !is_backside) {
      front0x = miter_px;
      front0y = miter_py;
    }
    const float back0x_j = apply_miter && is_backside ? miter_px : back0x;
    const float back0y_j = apply_miter && is_backside ? miter_py : back0y;

    const bool is_bevel = join_kind == kJoinBevel;
    const bool is_round_join = join_kind == kJoinRound;
    const bool bevel_valid =
        (front0x != front1x || front0y != front1y) && (back0x_j != back1x || back0y_j != back1y);

    const float arcj_0x = is_backside ? back0x : front0x;
    const float arcj_0y = is_backside ? back0y : front0y;
    const float arcj_1x = is_backside ? back1x : front1x;
    const float arcj_1y = is_backside ? back1y : front1y;
    const float otherj_0x = is_backside ? front0x : back0x;
    const float otherj_0y = is_backside ? front0y : back0y;
    const float otherj_1x = is_backside ? front1x : back1x;
    const float otherj_1y = is_backside ? front1y : back1y;

    const bool join_slot = regular && do_join;
    const bool cap_end_slot = regular && !do_join;

    const uint32_t ec_style = sf & kEndCapMask;
    const float ec_c0x = p3x + npx, ec_c0y = p3y + npy;
    const float ec_c1x = p3x - npx, ec_c1y = p3y - npy;

    const uint32_t sc_style = (sf & kStartCapMask) >> 2;
    float sc_otx, sc_oty;
    normalize(tan_sx, tan_sy, &sc_otx, &sc_oty);
    sc_otx = sc_otx * offset;
    sc_oty = sc_oty * offset;
    const float sc_nx = -sc_oty, sc_ny = sc_otx;
    const float sc_c0x = p0x - sc_nx, sc_c0y = p0y - sc_ny;
    const float sc_c1x = p0x + sc_nx, sc_c1y = p0y + sc_ny;

    const bool cap_slot = cap_end_slot || start_cap_slot;
    const bool sc = start_cap_slot;
    const uint32_t cap_style = sc ? sc_style : ec_style;
    const float cap_px = sc ? p0x : p3x, cap_py = sc ? p0y : p3y;
    const float cap_0x = sc ? sc_c0x : ec_c0x, cap_0y = sc ? sc_c0y : ec_c0y;
    const float cap_1x = sc ? sc_c1x : ec_c1x, cap_1y = sc ? sc_c1y : ec_c1y;
    const float cap_vx = sc ? -sc_otx : otx, cap_vy = sc ? -sc_oty : oty;
    const bool cap_round = cap_style == kCapRound;
    const bool cap_square = cap_style == kCapSquare;

    // sel3: the join's value on a join slot, the cap's on a cap slot, else 0.
    auto sel3 = [&](float jc, float cc) { return join_slot ? jc : (cap_slot ? cc : 0.0f); };

    s_valid[0] = (join_slot && ((is_bevel && bevel_valid) || is_miter || is_round_join)) ||
                 (cap_slot && !cap_round);
    const float j0x = is_round_join ? otherj_0x : front0x;
    const float j0y = is_round_join ? otherj_0y : front0y;
    const float j1x = is_round_join ? otherj_1x : front1x;
    const float j1y = is_round_join ? otherj_1y : front1y;
    const float c1x = cap_square ? cap_0x + cap_vx : cap_1x;
    const float c1y = cap_square ? cap_0y + cap_vy : cap_1y;
    const float s0[4] = {sel3(j0x, cap_0x), sel3(j0y, cap_0y), sel3(j1x, c1x), sel3(j1y, c1y)};

    s_valid[1] =
        (join_slot && ((is_bevel && bevel_valid) || is_miter)) || (cap_slot && cap_square);
    const float s1[4] = {sel3(back0x_j, cap_1x + cap_vx), sel3(back0y_j, cap_1y + cap_vy),
                         sel3(back1x, cap_1x), sel3(back1y, cap_1y)};

    s_valid[2] = (join_slot && apply_miter) || (cap_slot && cap_square);
    const float s2[4] = {sel3(p_mx, cap_0x + cap_vx), sel3(p_my, cap_0y + cap_vy),
                         sel3(miter_px, cap_1x + cap_vx), sel3(miter_py, cap_1y + cap_vy)};

    const bool arc_valid = (join_slot && is_round_join) || (cap_slot && cap_round);
    const float arc_bx = join_slot ? arcj_0x : cap_0x, arc_by = join_slot ? arcj_0y : cap_0y;
    const float arc_ex = join_slot ? arcj_1x : cap_1x, arc_ey = join_slot ? arcj_1y : cap_1y;
    const float arc_cx = join_slot ? p3x : cap_px, arc_cy = join_slot ? p3y : cap_py;
    const float arc_angle = join_slot ? fabsf(pm::arctan2(cr, dd)) : F(pm::kPi);
    float ab_tx, ab_ty, ac_tx, ac_ty;
    xform(T, arc_bx, arc_by, &ab_tx, &ab_ty);
    xform(T, arc_cx, arc_cy, &ac_tx, &ac_ty);
    // (a - b) ** 2 is one product on the card (torch's pow by 2).
    const float ddx = ab_tx - ac_tx, ddy = ab_ty - ac_ty;
    const float radius = pm::clamp_min(sqrtf(ddx * ddx + ddy * ddy), fm::kTol);
    const float arc_theta = pm::clamp_min(
        2.0f * pm::arccos(pm::clamp(1.0f - fm::kTol / radius, -1.0f, 1.0f)), F(0.0001));
    arc_nv = arc_valid ? pm::clamp_min(ceilf(arc_angle / arc_theta), 1.0f) : 0.0f;

    xform(T, s0[0], s0[1], &s_l[0][0], &s_l[0][1]);
    xform(T, s0[2], s0[3], &s_l[0][2], &s_l[0][3]);
    xform(T, s1[0], s1[1], &s_l[1][0], &s_l[1][1]);
    xform(T, s1[2], s1[3], &s_l[1][2], &s_l[1][3]);
    xform(T, s2[0], s2[1], &s_l[2][0], &s_l[2][1]);
    xform(T, s2[2], s2[3], &s_l[2][2], &s_l[2][3]);
    arc[0] = arc_bx;
    arc[1] = arc_by;
    arc[2] = arc_ex;
    arc[3] = arc_ey;
    arc[4] = arc_cx;
    arc[5] = arc_cy;
    arc[6] = arc_theta;
    arc[7] = arc_nv;

    counts2[i] = act_a;
    counts2[N + i] = act_b;
    const int o1 = s_valid[0], o2 = o1 + s_valid[1], o3 = o2 + s_valid[2];
    tot4[i] = o3 + (int)arc_nv;
    tgt[i] = tgt_v;
    arc_n_out[i] = arc_nv;
    uint32_t* s = s_rows[t >> 5];
    // orow and pmeta are staged past the float rows' end.
    s[kStage - 32 * 5 + lane * 3] = o1;
    s[kStage - 32 * 5 + lane * 3 + 1] = o2;
    s[kStage - 32 * 5 + lane * 3 + 2] = o3;
    s[kStage - 32 * 2 + lane * 2] = df;
    s[kStage - 32 * 2 + lane * 2 + 1] = trans;
  }

  // Each table's rows: staged a warp at a time, stored as one run. Lane
  // l's staged row starts an odd number of words after lane l - 1's, so a
  // warp's staging stores fall on 32 distinct banks.
  uint32_t* s = s_rows[t >> 5];
  store_rows(s + kStage - 32 * 5, reinterpret_cast<uint32_t*>(orow) + (size_t)row0 * 3, rows, 3,
             lane);
  store_rows(s + kStage - 32 * 2, reinterpret_cast<uint32_t*>(pmeta) + (size_t)row0 * 2, rows,
             2, lane);
  uint32_t* out2 = reinterpret_cast<uint32_t*>(tab2);
  if (live) stage_floats(s + lane * kEulerCols, tabA, kEulerCols);
  store_rows(s, out2 + (size_t)row0 * kEulerCols, rows, kEulerCols, lane);
  if (live) stage_floats(s + lane * kEulerCols, tabB, kEulerCols);
  store_rows(s, out2 + (size_t)(N + row0) * kEulerCols, rows, kEulerCols, lane);
  uint32_t* outs = reinterpret_cast<uint32_t*>(sa);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (live) {
      uint32_t* r = s + lane * kSaCols;
      if (k < 3) {
        stage_floats(r, s_l[k], 4);
        for (int c = 4; c < 14; ++c) r[c] = 0u;
      } else {
        stage_floats(r, arc, 8);
        stage_floats(r + 8, T, 6);
      }
      r[14] = __float_as_uint(tabA[20]);
    }
    store_rows(s, outs + ((size_t)k * N + row0) * kSaCols, rows, kSaCols, lane);
  }
}

}  // namespace

// scene [S] i32; the decoded tags [Ne] i32; the layout's path_data_base,
// style_base, transform_base and n_path_tags, each a 0-dim i32 on the
// device; the monoid's path_idx, path_seg_offset, style_idx and trans_idx
// [Ne] i32, `ms` words apart (one stride);
// tab2 [2N, 21] f32, counts2 [2N] i32, sa [4N, 15] f32, orow [N, 3] i32,
// tot4 [N] i32, tgt [N] i32, pmeta [N, 2] i32, arc_n [N] f32; ms, S, N, Ne,
// tag_lo, n_paths_cap, stream.
extern "C" int jello_slot_tables(const void* scene, const void* tags, const void* pdb,
                                 const void* sb, const void* tb, const void* npt,
                                 const void* path_idx, const void* seg_off,
                                 const void* style_idx, const void* trans_idx, void* tab2,
                                 void* counts2, void* sa, void* orow, void* tot4, void* tgt,
                                 void* pmeta, void* arc_n, long long ms, long long S, int N,
                                 int Ne, int tag_lo, int n_paths_cap, void* stream) {
  if (S < 1 || ms < 1 || N < 0 || Ne < N) return (int)cudaErrorInvalidValue;
  if (N > 0) {
    Inputs in{static_cast<const int*>(scene), S,
              static_cast<const int*>(tags), static_cast<const int*>(pdb),
              static_cast<const int*>(sb), static_cast<const int*>(tb),
              static_cast<const int*>(npt), static_cast<const int*>(path_idx),
              static_cast<const int*>(seg_off), static_cast<const int*>(style_idx),
              static_cast<const int*>(trans_idx), ms, N, Ne, tag_lo, n_paths_cap};
    slot_tables_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
        in, static_cast<float*>(tab2), static_cast<int*>(counts2), static_cast<float*>(sa),
        static_cast<int*>(orow), static_cast<int*>(tot4), static_cast<int*>(tgt),
        static_cast<int*>(pmeta), static_cast<float*>(arc_n));
  }
  return (int)cudaGetLastError();
}
