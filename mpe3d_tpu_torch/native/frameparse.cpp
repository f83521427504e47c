// Native wire-format frame parser — the host-side hot loop of the data
// pipeline.
//
// The reference parses its frame JSON with python json.loads per frame and
// per skeleton (pose_estimator_dataset_from_json.py:151-177,
// graph_generator.py:583-601), which dominates dataset-build wall clock.
// This is a single-pass recursive-descent parser over the raw bytes that
// fills dense [F, C, S, J] buffers directly — no intermediate objects.
//
// Wire schema (SURVEY.md §1): a file is a list of frames; a frame maps
// camera name → [skeletons_json_str, timestamp, 'no_image', gt?]; the
// skeletons string is itself JSON: a list of {joint_id: [id, x, y, valid,
// prob], "ID"?: ...} dicts.  The inner string is unescaped into a scratch
// buffer and parsed with the same machinery.  GT (element 3, a list of
// {joint_id: [x, y, z], "-1": marker} dicts in cm; reference:
// test/metrics_from_model.py:128-174) is parsed into dense per-camera
// buffers when requested, so the eval loop never touches python json.
//
// mpe3d_count_frames provides an exact frame count in a cheap first pass so
// callers allocate [F, ...] buffers exactly (no size-guessing).
//
// mpe3d_format_result writes one serve response line (the layout of
// serve.py's python record) without json.dumps.
//
// The PyTorch port's own copy of mpe3d_tpu/native/frameparse.cpp (the port
// imports nothing of the JAX package).  Build:
// g++ -O3 -shared -fPIC -std=c++17 frameparse.cpp -o libmpe3d_torch_frame.so
// (done lazily by mpe3d_tpu_torch/native/__init__.py into
// mpe3d_tpu_torch/_build/; python fallback otherwise).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Cursor {
  const char* p;
  const char* end;
  bool ok = true;

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }
  bool expect(char c) {
    skip_ws();
    if (p < end && *p == c) {
      ++p;
      return true;
    }
    ok = false;
    return false;
  }
  bool peek_is(char c) {
    skip_ws();
    return p < end && *p == c;
  }
};

// Parse a JSON string token (assumes cursor at opening quote); appends the
// unescaped bytes to `out`.
bool parse_string(Cursor& c, std::string& out) {
  out.clear();
  if (!c.expect('"')) return false;
  while (c.p < c.end) {
    char ch = *c.p++;
    if (ch == '"') return true;
    if (ch == '\\' && c.p < c.end) {
      char esc = *c.p++;
      switch (esc) {
        case 'n': out.push_back('\n'); break;
        case 't': out.push_back('\t'); break;
        case 'r': out.push_back('\r'); break;
        case 'b': out.push_back('\b'); break;
        case 'f': out.push_back('\f'); break;
        case 'u': {
          // wire payloads are ASCII; decode BMP code points naively
          if (c.end - c.p >= 4) {
            char hex[5] = {c.p[0], c.p[1], c.p[2], c.p[3], 0};
            long cp = strtol(hex, nullptr, 16);
            c.p += 4;
            if (cp < 0x80) {
              out.push_back(static_cast<char>(cp));
            } else {  // non-ASCII: emit '?' (never appears in this schema)
              out.push_back('?');
            }
          }
          break;
        }
        default: out.push_back(esc);
      }
    } else {
      out.push_back(ch);
    }
  }
  c.ok = false;
  return false;
}

bool parse_number(Cursor& c, double* v) {
  c.skip_ws();
  char* endp = nullptr;
  *v = strtod(c.p, &endp);
  if (endp == c.p) {
    c.ok = false;
    return false;
  }
  c.p = endp;
  return true;
}

// Skip any JSON value (used for GT payloads and unknown fields).
// Depth-bounded: a hostile line of nested brackets must fail the parse
// (rc != 0 → python fallback) instead of overflowing the C stack and
// killing the long-lived serving process.
bool skip_value(Cursor& c, int depth = 0) {
  if (depth > 512) return (c.ok = false);
  c.skip_ws();
  if (c.p >= c.end) return (c.ok = false);
  char ch = *c.p;
  if (ch == '"') {
    std::string tmp;
    return parse_string(c, tmp);
  }
  if (ch == '{') {
    ++c.p;
    if (c.peek_is('}')) { ++c.p; return true; }
    while (c.ok) {
      std::string key;
      if (!parse_string(c, key)) return false;
      if (!c.expect(':')) return false;
      if (!skip_value(c, depth + 1)) return false;
      c.skip_ws();
      if (c.p < c.end && *c.p == ',') { ++c.p; continue; }
      return c.expect('}');
    }
    return false;
  }
  if (ch == '[') {
    ++c.p;
    if (c.peek_is(']')) { ++c.p; return true; }
    while (c.ok) {
      if (!skip_value(c, depth + 1)) return false;
      c.skip_ws();
      if (c.p < c.end && *c.p == ',') { ++c.p; continue; }
      return c.expect(']');
    }
    return false;
  }
  // literal: number / true / false / null
  if (strncmp(c.p, "true", 4) == 0) { c.p += 4; return true; }
  if (strncmp(c.p, "false", 5) == 0) { c.p += 5; return true; }
  if (strncmp(c.p, "null", 4) == 0) { c.p += 4; return true; }
  double v;
  return parse_number(c, &v);
}

struct Buffers {
  float* kp;
  float* valid;
  float* prob;
  uint8_t* in_view;
  uint8_t* present;
  double* ts;
  int C, S, J;
  // optional ground-truth buffers (null = skip GT)
  float* gt = nullptr;        // [F, C, P, J, 3] raw wire units (cm)
  uint8_t* gt_valid = nullptr;   // [F, C, P, J]
  uint8_t* gt_pvalid = nullptr;  // [F, C, P] '-1' marker present
  int32_t* gt_count = nullptr;   // [F, C] list length (-1 = no GT element)
  int32_t* gt_order = nullptr;   // [F, C] file-order key position (-1 =
                                 // camera absent) — lets the wrapper
                                 // reproduce the reference's first-in-file-
                                 // order best-camera tie-break
  int P = 0;

  inline int64_t kp_idx(int64_t f, int ci, int s, int j) const {
    return (((f * C + ci) * S + s) * J + j) * 2;
  }
  inline int64_t j_idx(int64_t f, int ci, int s, int j) const {
    return ((f * C + ci) * S + s) * J + j;
  }
  inline int64_t gt_idx(int64_t f, int ci, int p, int j) const {
    return (((f * C + ci) * P + p) * J + j) * 3;
  }
  inline int64_t gtj_idx(int64_t f, int ci, int p, int j) const {
    return ((f * C + ci) * P + p) * J + j;
  }
};

// Parse one GT list (element 3 of a camera entry) into camera ci of frame f.
// Persons beyond b.P are consumed but not stored (the count still includes
// them, matching len(entry[3]) used for best-camera selection in python).
bool parse_gt_list(Cursor& c, const Buffers& b, int64_t f, int ci) {
  if (!c.expect('[')) return false;
  int32_t count = 0;
  if (c.peek_is(']')) {
    ++c.p;
    if (b.gt_count) b.gt_count[f * b.C + ci] = 0;
    return true;
  }
  while (c.ok) {
    if (!c.expect('{')) return false;
    int p = count;
    bool store_p = b.gt && p < b.P;
    if (c.peek_is('}')) {
      ++c.p;
    } else {
      while (c.ok) {
        std::string key;
        if (!parse_string(c, key)) return false;
        if (!c.expect(':')) return false;
        bool is_marker = (key == "-1");
        long j = -1;
        if (!is_marker) {
          // strict like python's int() (parse_frame_gt): a non-numeric
          // joint key is a parse failure, NOT a silent strtol→0 write
          // into joint 0 — same rule as the skeleton parser below
          char* endp = nullptr;
          j = strtol(key.c_str(), &endp, 10);
          if (key.empty() || endp == key.c_str() || *endp != '\0')
            return false;
        }
        if (is_marker && store_p && b.gt_pvalid)
          b.gt_pvalid[(f * b.C + ci) * b.P + p] = 1;
        bool store_j = store_p && !is_marker && j >= 0 && j < b.J;
        if (c.peek_is('[')) {
          ++c.p;
          double vals[3] = {0, 0, 0};
          int n = 0;
          if (!c.peek_is(']')) {
            while (c.ok) {
              double v;
              if (!parse_number(c, &v)) return false;
              if (n < 3) vals[n] = v;
              ++n;
              c.skip_ws();
              if (c.p < c.end && *c.p == ',') { ++c.p; continue; }
              break;
            }
          }
          if (!c.expect(']')) return false;
          // python assigns xyz[:3] into a (3,) slot: fewer than 3
          // coordinates raises there (broadcast error) for any stored
          // in-range joint — mirror that as a parse failure regardless
          // of the person cap (python has no cap)
          if (!is_marker && j >= 0 && j < b.J && n < 3) return false;
          if (store_j) {
            int64_t k = b.gt_idx(f, ci, p, (int)j);
            b.gt[k] = (float)vals[0];
            b.gt[k + 1] = (float)vals[1];
            b.gt[k + 2] = (float)vals[2];
            b.gt_valid[b.gtj_idx(f, ci, p, (int)j)] = 1;
          }
        } else {
          if (!skip_value(c)) return false;
        }
        c.skip_ws();
        if (c.p < c.end && *c.p == ',') { ++c.p; continue; }
        if (!c.expect('}')) return false;
        break;
      }
    }
    ++count;
    c.skip_ws();
    if (c.p < c.end && *c.p == ',') { ++c.p; continue; }
    if (!c.expect(']')) return false;
    if (b.gt_count) b.gt_count[f * b.C + ci] = count;
    return true;
  }
  return false;
}

// Parse one skeletons list (already-unescaped inner JSON) into camera ci of
// frame f.  Mirrors data/frames.py: slots fill in order, zero-joint
// skeletons get no slot, "ID" keys are ignored, out-of-range joints skipped.
bool parse_skeletons(const std::string& text, const Buffers& b, int64_t f,
                     int ci) {
  Cursor c{text.data(), text.data() + text.size()};
  if (!c.expect('[')) return false;
  if (c.peek_is(']')) { ++c.p; return true; }
  int slot = 0;
  while (c.ok) {
    // one skeleton dict
    if (!c.expect('{')) return false;
    int n_joints_seen = 0;
    if (c.peek_is('}')) {
      ++c.p;
    } else {
      while (c.ok) {
        std::string key;
        if (!parse_string(c, key)) return false;
        if (!c.expect(':')) return false;
        bool is_id = (key == "ID");
        long j = -1;
        if (!is_id) {
          // strict like python's int(): a non-numeric joint key is a
          // parse failure (the python path raises ValueError), NOT a
          // silent strtol→0 write into joint 0
          char* endp = nullptr;
          j = strtol(key.c_str(), &endp, 10);
          if (key.empty() || endp == key.c_str() || *endp != '\0')
            return false;
        }
        bool store = !is_id && j >= 0 && j < b.J && slot < b.S;
        // value: [id, x, y, valid, prob]
        if (c.peek_is('[')) {
          ++c.p;
          double vals[5] = {0, 0, 0, 0, 0};
          int n = 0;
          if (!c.peek_is(']')) {
            while (c.ok) {
              double v;
              if (!parse_number(c, &v)) return false;
              if (n < 5) vals[n] = v;
              ++n;
              c.skip_ws();
              if (c.p < c.end && *c.p == ',') { ++c.p; continue; }
              break;
            }
          }
          if (!c.expect(']')) return false;
          // a stored joint with fewer than 5 values is a failure too
          // (python: IndexError on values[1..4])
          if (store && n < 5) return false;
          if (store && n >= 5) {
            int64_t k = b.kp_idx(f, ci, slot, (int)j);
            int64_t m = b.j_idx(f, ci, slot, (int)j);
            b.kp[k] = (float)vals[1];
            b.kp[k + 1] = (float)vals[2];
            b.valid[m] = (float)vals[3];
            b.prob[m] = (float)vals[4];
            b.in_view[m] = 1;
            ++n_joints_seen;
          }
        } else {
          if (!skip_value(c)) return false;  // tolerate non-list values
        }
        c.skip_ws();
        if (c.p < c.end && *c.p == ',') { ++c.p; continue; }
        if (!c.expect('}')) return false;
        break;
      }
    }
    if (n_joints_seen > 0 && slot < b.S) {
      b.present[(f * b.C + ci) * b.S + slot] = 1;
      ++slot;
    } else if (slot < b.S) {
      // wipe any partial writes of an empty/oversized skeleton
      for (int j = 0; j < b.J; ++j) {
        int64_t k = b.kp_idx(f, ci, slot, j);
        int64_t m = b.j_idx(f, ci, slot, j);
        b.kp[k] = b.kp[k + 1] = 0.f;
        b.valid[m] = b.prob[m] = 0.f;
        b.in_view[m] = 0;
      }
    }
    c.skip_ws();
    if (c.p < c.end && *c.p == ',') { ++c.p; continue; }
    return c.expect(']');
  }
  return false;
}

}  // namespace

extern "C" {

// Exact top-level frame count: one cheap scan tracking string state and
// bracket depth; counts '{' openings at depth 1 (each frame is an object
// element of the top-level list).  Returns -1 on malformed leading token.
int64_t mpe3d_count_frames(const char* text, int64_t text_len) {
  int64_t count = 0;
  int depth = 0;
  bool in_str = false, esc = false;
  bool seen_open = false;
  for (int64_t i = 0; i < text_len; ++i) {
    char ch = text[i];
    if (in_str) {
      if (esc) esc = false;
      else if (ch == '\\') esc = true;
      else if (ch == '"') in_str = false;
      continue;
    }
    switch (ch) {
      case '"': in_str = true; break;
      case '[': ++depth; seen_open = true; break;
      case ']': --depth; break;
      case '{':
        if (depth == 1) ++count;
        ++depth;
        break;
      case '}': --depth; break;
      default: break;
    }
  }
  return seen_open ? count : -1;
}

// Returns 0 on success; fills n_frames_out with the number parsed.
// Buffers must be zero-initialised [max_frames, C, S, J, ...] C-order.
// GT buffers may all be null (GT elements are then skipped); max_persons
// is the GT person capacity per (frame, camera).
int mpe3d_parse_frames_v3(const char* text, int64_t text_len,
                          const char** cam_names, int n_cams, int max_skel,
                          int n_joints, int64_t max_frames, float* kp,
                          float* valid, float* prob, uint8_t* in_view,
                          uint8_t* present, double* timestamps,
                          float* gt, uint8_t* gt_valid, uint8_t* gt_pvalid,
                          int32_t* gt_count, int32_t* gt_order,
                          int max_persons, int64_t* n_frames_out) {
  Cursor c{text, text + text_len};
  Buffers b{kp, valid, prob, in_view, present, timestamps,
            n_cams, max_skel, n_joints};
  b.gt = gt;
  b.gt_valid = gt_valid;
  b.gt_pvalid = gt_pvalid;
  b.gt_count = gt_count;
  b.gt_order = gt_order;
  b.P = max_persons;
  *n_frames_out = 0;
  if (!c.expect('[')) return 1;
  if (c.peek_is(']')) { ++c.p; return 0; }
  int64_t f = 0;
  std::string key, inner;
  while (c.ok) {
    if (f >= max_frames) return 2;
    if (!c.expect('{')) return 1;
    if (c.peek_is('}')) {
      ++c.p;
    } else {
      int32_t key_pos = 0;   // file-order position within this frame
      while (c.ok) {
        if (!parse_string(c, key)) return 1;
        if (!c.expect(':')) return 1;
        int ci = -1;
        for (int i = 0; i < n_cams; ++i) {
          if (key == cam_names[i]) { ci = i; break; }
        }
        if (ci >= 0 && b.gt_order) b.gt_order[f * b.C + ci] = key_pos;
        ++key_pos;
        if (ci < 0) {
          if (!skip_value(c)) return 1;
        } else {
          // entry: [skeletons_str, ts?, 'no_image'?, gt?]
          if (!c.expect('[')) return 1;
          if (!parse_string(c, inner)) return 1;
          if (!parse_skeletons(inner, b, f, ci)) return 1;
          int elem = 1;
          c.skip_ws();
          while (c.p < c.end && *c.p == ',') {
            ++c.p;
            if (elem == 1 && !c.peek_is('"') && !c.peek_is('[') &&
                !c.peek_is('{')) {
              double ts;
              if (!parse_number(c, &ts)) return 1;
              timestamps[f * n_cams + ci] = ts;
            } else if (elem == 3 && b.gt_count && c.peek_is('[')) {
              if (!parse_gt_list(c, b, f, ci)) return 1;
            } else {
              if (!skip_value(c)) return 1;
            }
            ++elem;
            c.skip_ws();
          }
          if (!c.expect(']')) return 1;
        }
        c.skip_ws();
        if (c.p < c.end && *c.p == ',') { ++c.p; continue; }
        if (!c.expect('}')) return 1;
        break;
      }
    }
    ++f;
    c.skip_ws();
    if (c.p < c.end && *c.p == ',') { ++c.p; continue; }
    if (!c.expect(']')) return 1;
    break;
  }
  *n_frames_out = f;
  return c.ok ? 0 : 1;
}

// ---------------------------------------------------------------------
// Serving response serializer — the output-side twin of the wire parser.
// Formats one result line exactly like serve.py::PoseServer._finish's
// dict (same keys, same order, same rounding: poses 4 decimals, quality
// 2, latency 3) without json.dumps, and shorter on the wire ("%.4f"
// instead of the python repr of a rounded float32).  Returns bytes
// written (incl. trailing '\n'), or -1 when the
// buffer is too small or any value is non-finite (caller falls back to
// the python path, which preserves json.dumps' NaN behaviour).
static inline bool put(char* out, int64_t cap, int64_t& n,
                       const char* s, int64_t len) {
  if (n + len > cap) return false;
  memcpy(out + n, s, len);
  n += len;
  return true;
}

static inline bool put_num(char* out, int64_t cap, int64_t& n,
                           const char* fmt, double v) {
  if (!std::isfinite(v)) return false;
  char buf[40];
  int len = snprintf(buf, sizeof buf, fmt, v);
  if (len <= 0) return false;
  return put(out, cap, n, buf, len);
}

int64_t mpe3d_format_result(int64_t seq, int64_t dropped,
                            const float* poses, int64_t P, int64_t J,
                            const float* quality, const int32_t* track_ids,
                            double latency_ms, char* out, int64_t cap) {
  int64_t n = 0;
  char head[96];
  int hl = snprintf(head, sizeof head, "{\"seq\": %lld",
                    (long long) seq);
  if (!put(out, cap, n, head, hl)) return -1;
  if (dropped > 0) {
    hl = snprintf(head, sizeof head, ", \"dropped_low_quality\": %lld",
                  (long long) dropped);
    if (!put(out, cap, n, head, hl)) return -1;
  }
  hl = snprintf(head, sizeof head, ", \"n_persons\": %lld", (long long) P);
  if (!put(out, cap, n, head, hl)) return -1;
  if (track_ids) {
    if (!put(out, cap, n, ", \"track_ids\": [", 16)) return -1;
    for (int64_t p = 0; p < P; ++p) {
      hl = snprintf(head, sizeof head, p ? ", %d" : "%d", track_ids[p]);
      if (!put(out, cap, n, head, hl)) return -1;
    }
    if (!put(out, cap, n, "]", 1)) return -1;
  }
  if (quality) {
    if (!put(out, cap, n, ", \"quality_px\": [", 17)) return -1;
    for (int64_t p = 0; p < P; ++p) {
      if (p && !put(out, cap, n, ", ", 2)) return -1;
      if (!put_num(out, cap, n, "%.2f", quality[p])) return -1;
    }
    if (!put(out, cap, n, "]", 1)) return -1;
  }
  if (!put(out, cap, n, ", \"poses_m\": [", 14)) return -1;
  for (int64_t p = 0; p < P; ++p) {
    if (p && !put(out, cap, n, ", ", 2)) return -1;
    if (!put(out, cap, n, "[", 1)) return -1;
    for (int64_t j = 0; j < J; ++j) {
      if (j && !put(out, cap, n, ", ", 2)) return -1;
      if (!put(out, cap, n, "[", 1)) return -1;
      for (int64_t k = 0; k < 3; ++k) {
        if (k && !put(out, cap, n, ", ", 2)) return -1;
        if (!put_num(out, cap, n, "%.4f", poses[(p * J + j) * 3 + k]))
          return -1;
      }
      if (!put(out, cap, n, "]", 1)) return -1;
    }
    if (!put(out, cap, n, "]", 1)) return -1;
  }
  if (!put(out, cap, n, "]", 1)) return -1;
  if (!put(out, cap, n, ", \"latency_ms\": ", 16)) return -1;
  if (!put_num(out, cap, n, "%.3f", latency_ms)) return -1;
  if (!put(out, cap, n, "}\n", 2)) return -1;
  return n;
}

}  // extern "C"
