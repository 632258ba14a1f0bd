// Native path encoder (reference: encoding/path.go).
// The port's own copy of jello_tpu/native/encoder.cpp (same text).
//
// The host-side hot loop of scene construction: converting path
// elements into the tag/data streams. Exact port of the PathEncoder
// state machine, including zero-length segment culling, the
// treat-initial-draw-as-move kurbo rule, implicit fill closing and
// stroke cap-marker segments. Exposed with a C ABI and driven from
// Python via ctypes (see native/__init__.py); semantics are verified
// against the pure-Python encoder by tests/test_native.py.

#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

constexpr double kEps = 1e-12;  // jmath.Epsilon

constexpr uint8_t TAG_LINE_F32 = 0x9;
constexpr uint8_t TAG_QUAD_F32 = 0xA;
constexpr uint8_t TAG_CUBIC_F32 = 0xB;
constexpr uint8_t TAG_SUBPATH_END = 0x4;

enum State { kStart = 0, kMoveTo = 1, kNonempty = 2 };

struct Enc {
  uint8_t* tags;
  int32_t ntags;
  float* data;  // xy pairs, flat floats
  int32_t ndata;
  int32_t nsegs;
  int state;
  bool is_fill;
  float first[2];
  float first_tan[2];
};

inline void push_pt(Enc& e, float x, float y) {
  e.data[e.ndata++] = x;
  e.data[e.ndata++] = y;
}

inline void pop_pt(Enc& e) { e.ndata -= 2; }

inline bool last_pt(const Enc& e, float* out) {
  if (e.ndata < 2) return false;
  out[0] = e.data[e.ndata - 2];
  out[1] = e.data[e.ndata - 1];
  return true;
}

bool zero_len(const Enc& e, const float* p1, const float* p2, const float* p3) {
  float p0[2];
  if (!last_pt(e, p0)) return true;
  const float* q2 = p2 ? p2 : p1;
  const float* q3 = p3 ? p3 : p1;
  float xmin = std::min(std::min(p0[0], p1[0]), std::min(q2[0], q3[0]));
  float xmax = std::max(std::max(p0[0], p1[0]), std::max(q2[0], q3[0]));
  float ymin = std::min(std::min(p0[1], p1[1]), std::min(q2[1], q3[1]));
  float ymax = std::max(std::max(p0[1], p1[1]), std::max(q2[1], q3[1]));
  return !(xmax - xmin > kEps || ymax - ymin > kEps);
}

bool start_tangent(const Enc& e, const float* p1, const float* p2,
                   const float* p3, float* out) {
  const float* p0 = e.first;
  const float* q2 = p2 ? p2 : p0;
  const float* q3 = p3 ? p3 : p0;
  const float* pick = nullptr;
  if (std::abs(p1[0] - p0[0]) > kEps || std::abs(p1[1] - p0[1]) > kEps)
    pick = p1;
  else if (std::abs(q2[0] - p0[0]) > kEps || std::abs(q2[1] - p0[1]) > kEps)
    pick = q2;
  else if (std::abs(q3[0] - p0[0]) > kEps || std::abs(q3[1] - p0[1]) > kEps)
    pick = q3;
  if (!pick) return false;
  out[0] = pick[0];
  out[1] = pick[1];
  return true;
}

void line_to(Enc& e, float x, float y);
void quad_to(Enc& e, float x1, float y1, float x2, float y2);

void insert_cap_marker(Enc& e, bool is_closed) {
  if (is_closed) {
    line_to(e, e.first_tan[0], e.first_tan[1]);
  } else {
    quad_to(e, e.first[0], e.first[1], e.first_tan[0], e.first_tan[1]);
  }
}

void close(Enc& e);

void move_to(Enc& e, float x, float y) {
  if (e.is_fill) close(e);
  if (e.state == kMoveTo) {
    pop_pt(e);
  } else if (e.state == kNonempty) {
    if (!e.is_fill) insert_cap_marker(e, false);
    if (e.ntags > 0) e.tags[e.ntags - 1] |= TAG_SUBPATH_END;
  }
  e.first[0] = x;
  e.first[1] = y;
  push_pt(e, x, y);
  e.state = kMoveTo;
}

void line_to(Enc& e, float x, float y) {
  if (e.state == kStart) {
    if (e.nsegs == 0) {
      move_to(e, x, y);
      return;
    }
    move_to(e, e.first[0], e.first[1]);
  }
  float p1[2] = {x, y};
  if (e.state == kMoveTo) {
    float t[2];
    if (!start_tangent(e, p1, nullptr, nullptr, t)) return;
    e.first_tan[0] = t[0];
    e.first_tan[1] = t[1];
  }
  if (zero_len(e, p1, nullptr, nullptr)) return;
  push_pt(e, x, y);
  e.tags[e.ntags++] = TAG_LINE_F32;
  e.state = kNonempty;
  e.nsegs++;
}

void quad_to(Enc& e, float x1, float y1, float x2, float y2) {
  if (e.state == kStart) {
    if (e.nsegs == 0) {
      move_to(e, x2, y2);
      return;
    }
    move_to(e, e.first[0], e.first[1]);
  }
  float p1[2] = {x1, y1}, p2[2] = {x2, y2};
  if (e.state == kMoveTo) {
    float zero[2] = {0, 0};
    float t[2];
    if (!start_tangent(e, p1, p2, zero, t)) return;
    e.first_tan[0] = t[0];
    e.first_tan[1] = t[1];
  }
  if (zero_len(e, p1, p2, nullptr)) return;
  push_pt(e, x1, y1);
  push_pt(e, x2, y2);
  e.tags[e.ntags++] = TAG_QUAD_F32;
  e.state = kNonempty;
  e.nsegs++;
}

void cubic_to(Enc& e, float x1, float y1, float x2, float y2, float x3,
              float y3) {
  if (e.state == kStart) {
    if (e.nsegs == 0) {
      move_to(e, x3, y3);
      return;
    }
    move_to(e, e.first[0], e.first[1]);
  }
  float p1[2] = {x1, y1}, p2[2] = {x2, y2}, p3[2] = {x3, y3};
  if (e.state == kMoveTo) {
    float t[2];
    if (!start_tangent(e, p1, p2, p3, t)) return;
    e.first_tan[0] = t[0];
    e.first_tan[1] = t[1];
  }
  if (zero_len(e, p1, p2, p3)) return;
  push_pt(e, x1, y1);
  push_pt(e, x2, y2);
  push_pt(e, x3, y3);
  e.tags[e.ntags++] = TAG_CUBIC_F32;
  e.state = kNonempty;
  e.nsegs++;
}

void close(Enc& e) {
  if (e.state == kStart) return;
  if (e.state == kMoveTo) {
    pop_pt(e);
    e.state = kStart;
    return;
  }
  if (e.ndata < 2) return;
  // Bitwise comparison, as the reference compares raw bytes
  // (path.go:390-393).
  if (std::memcmp(&e.data[e.ndata - 2], &e.first[0], 8) != 0) {
    push_pt(e, e.first[0], e.first[1]);
    e.tags[e.ntags++] = TAG_LINE_F32;
    e.nsegs++;
  }
  if (!e.is_fill) insert_cap_marker(e, true);
  if (e.ntags > 0) e.tags[e.ntags - 1] |= TAG_SUBPATH_END;
  e.state = kStart;
}

}  // namespace

extern "C" {

// kinds: 0=move_to 1=line_to 2=quad_to 3=cubic_to 4=close
// pts: 6 floats per element.
// Returns the number of encoded segments; fills *out_ntags/*out_ndata
// (floats). Buffers must have room for 4*n + 8 tags and (6*n + 16)
// floats (worst case incl. closing line + cap marker).
int32_t jello_encode_path(const uint8_t* kinds, const float* pts, int32_t n,
                          int32_t is_fill, uint8_t* tags, float* data,
                          int32_t* out_ntags, int32_t* out_ndata) {
  Enc e{};
  e.tags = tags;
  e.data = data;
  e.is_fill = is_fill != 0;
  for (int32_t i = 0; i < n; i++) {
    const float* p = pts + i * 6;
    switch (kinds[i]) {
      case 0:
        move_to(e, p[0], p[1]);
        break;
      case 1:
        line_to(e, p[0], p[1]);
        break;
      case 2:
        quad_to(e, p[0], p[1], p[2], p[3]);
        break;
      case 3:
        cubic_to(e, p[0], p[1], p[2], p[3], p[4], p[5]);
        break;
      case 4:
        close(e);
        break;
    }
  }
  // finish(): (path marker is appended by the Python caller)
  if (e.is_fill) close(e);
  if (e.state == kMoveTo) pop_pt(e);
  if (e.nsegs != 0) {
    if (!e.is_fill && e.state == kNonempty) insert_cap_marker(e, false);
    if (e.ntags > 0) e.tags[e.ntags - 1] |= TAG_SUBPATH_END;
  }
  *out_ntags = e.ntags;
  *out_ndata = e.ndata;
  return e.nsegs;
}
}
