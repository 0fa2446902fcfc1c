// Native runtime for the path tracer: the in-repo C++ replacement for
// the native capability the reference pulled from external packages
// (SURVEY.md §2.2).  Three roles:
//
//   1. SFC32 PRNG (sfc-random-accelerate's generator,
//      upstream cabal.project:61-65) — bit-exact with the JAX and
//      numpy twins in ops/rng.py, so RNG streams can be cross-checked
//      between all three implementations.
//
//   2. Display/output fast path: tonemap + pixel interleave + PNG encode.
//      The reference's naive host-side pixel conversion cost ~200 ms per
//      frame until it dropped to a native path
//      (upstream app/Main.hs:378-381); this is the same move —
//      utils/image.py calls into here when the library is built.
//
//   3. A scalar float32 oracle renderer implementing the reference's
//      `render Inline` semantics (upstream src/Scene/Trace.hs:344-383)
//      one ray at a time — the closest in-repo analog to the Accelerate CPU
//      backend the north-star parity clause names, and a second
//      independent implementation (after parity/oracle_np.py) that the JAX
//      renderer is checked against.
//
// Pure C ABI; loaded from Python with ctypes (no pybind11 in this image).
// Build: runtime/build.py (g++ -O2 -shared -fPIC ... -lz).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

// ---------------------------------------------------------------------------
// SFC32 (Chris Doty-Humphrey's Small Fast Counting generator; the algorithm
// behind sfc-random-accelerate).  State per lane: (a, b, c, counter).
// ---------------------------------------------------------------------------

static inline uint32_t sfc32_step(uint32_t *s) {
  uint32_t t = s[0] + s[1] + s[3];
  s[3] += 1u;
  s[0] = s[1] ^ (s[1] >> 9);
  s[1] = s[2] + (s[2] << 3);
  s[2] = ((s[2] << 21) | (s[2] >> 11)) + t;
  return t;
}

// Advance every lane's state `rounds` times. state: [n_lanes, 4] u32.
extern "C" void ptru_sfc32_advance(uint32_t *state, int64_t n_lanes, int rounds) {
  for (int64_t i = 0; i < n_lanes; ++i)
    for (int r = 0; r < rounds; ++r) sfc32_step(state + 4 * i);
}

// Draw `draws` uniforms in [0,1) per lane into out [n_lanes, draws].
extern "C" void ptru_sfc32_uniforms(uint32_t *state, float *out, int64_t n_lanes,
                         int draws) {
  const float inv = 1.0f / 16777216.0f;  // 2^-24
  for (int64_t i = 0; i < n_lanes; ++i)
    for (int d = 0; d < draws; ++d)
      out[i * draws + d] = (float)(sfc32_step(state + 4 * i) >> 8) * inv;
}

// ---------------------------------------------------------------------------
// Tonemap + PNG output
// ---------------------------------------------------------------------------

// HDR [n_px, 3] f32 -> LDR [n_px, 3] u8: exposure, Reinhard, gamma.
// Bit-identical formula to utils/image.py:tonemap.
extern "C" void ptru_tonemap_rgb8(const float *hwc, uint8_t *out, int64_t n_px,
                       float exposure, float inv_gamma) {
  int64_t n = n_px * 3;
  for (int64_t i = 0; i < n; ++i) {
    float x = hwc[i] * exposure;
    x = x / (1.0f + x);
    x = x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
    x = powf(x, inv_gamma);
    out[i] = (uint8_t)(x * 255.0f + 0.5f);
  }
}

static void png_chunk(FILE *f, const char tag[4], const uint8_t *data,
                      uint32_t len) {
  uint8_t hdr[8] = {(uint8_t)(len >> 24), (uint8_t)(len >> 16),
                    (uint8_t)(len >> 8),  (uint8_t)len,
                    (uint8_t)tag[0],      (uint8_t)tag[1],
                    (uint8_t)tag[2],      (uint8_t)tag[3]};
  fwrite(hdr, 1, 8, f);
  if (len) fwrite(data, 1, len, f);
  uint32_t crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, hdr + 4, 4);
  if (len) crc = crc32(crc, data, len);
  uint8_t cb[4] = {(uint8_t)(crc >> 24), (uint8_t)(crc >> 16),
                   (uint8_t)(crc >> 8), (uint8_t)crc};
  fwrite(cb, 1, 4, f);
}

// 8-bit RGB PNG (filter 0 per scanline, zlib level 6). Returns 0 on success.
extern "C" int ptru_write_png(const char *path, const uint8_t *rgb, int w, int h) {
  int64_t stride = (int64_t)w * 3;
  std::vector<uint8_t> raw((stride + 1) * h);
  for (int y = 0; y < h; ++y) {
    raw[(stride + 1) * y] = 0;
    memcpy(&raw[(stride + 1) * y + 1], rgb + stride * y, stride);
  }
  uLongf comp_cap = compressBound(raw.size());
  std::vector<uint8_t> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(), raw.size(), 6) != Z_OK)
    return 1;

  FILE *f = fopen(path, "wb");
  if (!f) return 2;
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  fwrite(sig, 1, 8, f);
  uint8_t ihdr[13] = {(uint8_t)(w >> 24), (uint8_t)(w >> 16), (uint8_t)(w >> 8),
                      (uint8_t)w,         (uint8_t)(h >> 24), (uint8_t)(h >> 16),
                      (uint8_t)(h >> 8),  (uint8_t)h,         8,
                      2,                  0,                  0,
                      0};
  png_chunk(f, "IHDR", ihdr, 13);
  png_chunk(f, "IDAT", comp.data(), (uint32_t)comp_cap);
  png_chunk(f, "IEND", nullptr, 0);
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Scalar float32 oracle renderer — `render Inline` / `traceInline`
// (upstream src/Scene/Trace.hs:193-200, 344-383), one ray at a time.
// ---------------------------------------------------------------------------

namespace {

struct V3 {
  float x, y, z;
};
static inline V3 v3(float x, float y, float z) { return {x, y, z}; }
static inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
static inline V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
static inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline V3 normalize(V3 a) {
  float n = sqrtf(dot(a, a));
  return a * (1.0f / n);
}

struct Quat {
  float w, x, y, z;
};

// anglesToQuaternion (upstream src/Util.hs:55-67); angles = (roll,
// pitch, yaw), quaternion (w, x, y, z).
static inline Quat angles_to_quat(V3 ang) {
  float cy = cosf(ang.z * 0.5f), sy = sinf(ang.z * 0.5f);
  float cp = cosf(ang.y * 0.5f), sp = sinf(ang.y * 0.5f);
  float cr = cosf(ang.x * 0.5f), sr = sinf(ang.x * 0.5f);
  return {cy * cp * cr + sy * sp * sr, cy * cp * sr - sy * sp * cr,
          sy * cp * sr + cy * sp * cr, sy * cp * cr - cy * sp * sr};
}

// Linear.rotate: v + 2w(u x v) + 2(u x (u x v)).
static inline V3 quat_rotate(Quat q, V3 v) {
  V3 u = {q.x, q.y, q.z};
  V3 t = cross(u, v) * 2.0f;
  return v + t * q.w + cross(u, t);
}

constexpr float kInfinite = 3.402823466e+38f;  // max Float (Trace.hs:450-451)
constexpr float kEpsilon = 0.002f;             // Trace.hs:455-456
constexpr float kPi = 3.14159265358979323846f;

struct SceneView {
  const float *s_pos;   // [ns, 3]
  const float *s_rad;   // [ns]
  const float *p_pos;   // [np, 3]
  const float *p_nor;   // [np, 3]
  const float *color;   // [ns+np, 3] (spheres then planes)
  const float *illum;   // [ns+np]
  const int32_t *kind;  // [ns+np]
  const float *param;   // [ns+np]
  int ns, np;
};

struct HitInfo {
  bool hit;
  int prim;
  V3 point, normal;
};

// checkHit: nearest-hit linear scan with first-primitive tie-break
// (Trace.hs:443-447, Util.hs:171-178); sphere rules Intersection.hs:39-48,
// plane rules Intersection.hs:57-62.
static HitInfo nearest_hit(const SceneView &S, V3 o, V3 d) {
  float best_t = kInfinite;
  int best = -1;
  for (int i = 0; i < S.ns; ++i) {
    V3 c = {S.s_pos[3 * i], S.s_pos[3 * i + 1], S.s_pos[3 * i + 2]};
    V3 l = c - o;
    float tca = dot(l, d);
    float d2 = dot(l, l) - tca * tca;
    float r2 = S.s_rad[i] * S.s_rad[i];
    float thc = sqrtf(fmaxf(r2 - d2, 0.0f));
    float t = tca - thc;
    if (tca < 0.0f || d2 > r2 || t < 0.0f) continue;
    if (t < best_t) {
      best_t = t;
      best = i;
    }
  }
  for (int i = 0; i < S.np; ++i) {
    V3 n = {S.p_nor[3 * i], S.p_nor[3 * i + 1], S.p_nor[3 * i + 2]};
    V3 p = {S.p_pos[3 * i], S.p_pos[3 * i + 1], S.p_pos[3 * i + 2]};
    float denom = dot(d, n);
    float num = dot(p - o, n);
    float dist = num / (denom == 0.0f ? 5e-7f : denom);
    if (denom > 1e-6f || dist < 0.0f) continue;
    if (dist < best_t) {
      best_t = dist;
      best = S.ns + i;
    }
  }
  HitInfo h;
  h.hit = best >= 0;
  h.prim = h.hit ? best : 0;
  V3 point = o + d * (h.hit ? best_t : 0.0f);
  h.point = point;
  if (h.hit && best < S.ns) {
    V3 c = {S.s_pos[3 * best], S.s_pos[3 * best + 1], S.s_pos[3 * best + 2]};
    h.normal = normalize(point - c);
  } else {
    int pi = h.hit ? best - S.ns : 0;
    h.normal = {S.p_nor[3 * pi], S.p_nor[3 * pi + 1], S.p_nor[3 * pi + 2]};
  }
  return h;
}

// calcNextRay (Trace.hs:394-435): Matte/Glossy importance sampling with the
// reference's (self-admittedly wrong, Trace.hs:393) weights.
static void calc_next_ray(const SceneView &S, const HitInfo &h, V3 d,
                          uint32_t *rng, V3 *out_o, V3 *out_d, V3 *out_tmod) {
  const float inv = 1.0f / 16777216.0f;
  V3 rv = {(float)(sfc32_step(rng) >> 8) * inv * 2.0f - 1.0f,
           (float)(sfc32_step(rng) >> 8) * inv * 2.0f - 1.0f,
           (float)(sfc32_step(rng) >> 8) * inv * 2.0f - 1.0f};
  float p = S.param[h.prim];
  V3 nxt;
  float b;
  if (S.kind[h.prim] == 1) {  // Glossy (Trace.hs:419-429)
    V3 refl = d - h.normal * (2.0f * dot(d, h.normal));
    nxt = quat_rotate(angles_to_quat(rv * (1.0f - p)), refl);
    b = fmaxf(0.0f, dot(nxt, refl));
  } else {  // Matte (Trace.hs:407-411)
    nxt = quat_rotate(angles_to_quat(rv * kPi), h.normal);
    b = p / kPi * dot(nxt, h.normal);
  }
  *out_o = h.point + nxt * kEpsilon;
  *out_d = nxt;
  float scale = b * (1.0f / (2.0f * kPi));
  V3 col = {S.color[3 * h.prim], S.color[3 * h.prim + 1],
            S.color[3 * h.prim + 2]};
  *out_tmod = col * scale;
}

struct CameraBasis {
  V3 pos, center, right, top;
};

// primaryRays setup (Trace.hs:205-262) — virtual screen plane frame.
static CameraBasis camera_basis(const float *cpos, const float *crot, float fov,
                                int width, int height) {
  V3 pos = {cpos[0], cpos[1], cpos[2]};
  float screen_angle = fov * kPi / 180.0f / 2.0f;
  float screen_distance = 1.0f / tanf(screen_angle);
  float screen_half_width = tanf(screen_angle) * screen_distance;
  V3 forward = {0.0f, 0.0f, -1.0f}, up = {0.0f, 1.0f, 0.0f};
  V3 c_dir = quat_rotate(angles_to_quat({crot[0], crot[1], crot[2]}), forward);
  V3 center = pos + c_dir * screen_distance;
  V3 right = normalize(cross(center - pos, up)) * (1.0f / screen_half_width);
  float aspect = (float)width / (float)height;
  V3 top = cross(c_dir, right) * (1.0f / aspect);
  return {pos, center, right, top};
}

}  // namespace

// One progressive sample over a row range: color [h, w, 3] f32 accumulates
// radiance (new + old, Trace.hs:193-196), rng [h, w, 4] u32 advances in
// place.  Rows [row0, row1).
static void render_rows(const SceneView &S, const CameraBasis &C, int width,
                        int height, int bounces, int spp, float *color,
                        uint32_t *rng, int row0, int row1) {
  for (int y = row0; y < row1; ++y) {
    for (int x = 0; x < width; ++x) {
      int64_t px = (int64_t)y * width + x;
      uint32_t *st = rng + 4 * px;
      V3 acc = {color[3 * px], color[3 * px + 1], color[3 * px + 2]};
      // rasterPos / screenSize * 2 + (-1, 1) with screenSize = (w, -h)
      // (Util.hs:198-200).
      float sx = (float)x / (float)width * 2.0f - 1.0f;
      float sy = (float)y / (float)(-height) * 2.0f + 1.0f;
      V3 point = C.center + C.right * sx + C.top * sy;
      V3 pd = normalize(point - C.pos);
      for (int s = 0; s < spp; ++s) {
        V3 o = C.pos, d = pd;
        V3 result = {0, 0, 0}, thpt = {1, 1, 1};
        for (int bounce = 0; bounce < bounces; ++bounce) {
          HitInfo h = nearest_hit(S, o, d);
          bool dead = dot(thpt, thpt) <= 1e-6f || !h.hit;
          if (dead) {  // dead lanes idle (Trace.hs:364-365)
            thpt = {0, 0, 0};
            continue;
          }
          V3 no, nd, tmod;
          calc_next_ray(S, h, d, st, &no, &nd, &tmod);
          V3 col = {S.color[3 * h.prim], S.color[3 * h.prim + 1],
                    S.color[3 * h.prim + 2]};
          result = result + col * S.illum[h.prim] * thpt;
          thpt = thpt * tmod;
          o = no;
          d = nd;
        }
        acc = acc + result;
      }
      color[3 * px] = acc.x;
      color[3 * px + 1] = acc.y;
      color[3 * px + 2] = acc.z;
    }
  }
}

// Entry: render `spp` samples of the whole image, multithreaded over rows.
extern "C" void ptru_render_inline(const float *s_pos, const float *s_rad, int ns,
                        const float *p_pos, const float *p_nor, int np,
                        const float *color_, const float *illum,
                        const int32_t *kind, const float *param,
                        const float *cam_pos, const float *cam_rot, float fov,
                        int width, int height, int bounces, int spp,
                        float *color, uint32_t *rng, int n_threads) {
  SceneView S = {s_pos, s_rad, p_pos, p_nor, color_, illum, kind, param, ns, np};
  CameraBasis C = camera_basis(cam_pos, cam_rot, fov, width, height);
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads < 1) n_threads = 1;
  }
  if (n_threads > height) n_threads = height;
  std::vector<std::thread> ts;
  int rows_per = (height + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int r0 = t * rows_per, r1 = r0 + rows_per;
    if (r1 > height) r1 = height;
    if (r0 >= r1) break;
    ts.emplace_back([&, r0, r1] {
      render_rows(S, C, width, height, bounces, spp, color, rng, r0, r1);
    });
  }
  for (auto &t : ts) t.join();
}


// ===========================================================================
// Physical/NEE estimator oracle (round 5): scalar float32 twin of
// render/nee.py:trace_physical(nee=True) under the
// shade-frame convention — the third independent implementation of the
// NEE family next to the JAX estimator and the numpy oracle
// (parity/oracle_nee_np.py).  Spheres + planes + triangles; corrected
// BRDFs (Lambert cosine, mirror glossy, Fresnel glass), cone/area light
// sampling with the robust one-minus forms, any-occluder shadow window.
// ===========================================================================

struct NeeScene {
  const float *s_pos;   // [ns, 3]
  const float *s_rad;   // [ns]
  const float *p_pos;   // [np, 3]
  const float *p_nor;   // [np, 3]
  const float *t_v0;    // [nt, 3]
  const float *t_v1;    // [nt, 3]
  const float *t_v2;    // [nt, 3]
  const float *color;   // [ns+np+nt, 3] (spheres, planes, tris)
  const float *illum;   // [ns+np+nt]
  const int32_t *kind;  // [ns+np+nt]
  const float *param;   // [ns+np+nt]
  int ns, np, nt;
};

static inline V3 row3(const float *a, int i) {
  return {a[3 * i], a[3 * i + 1], a[3 * i + 2]};
}

// Shade-frame nearest hit: sphere_distances' clamp form with the
// `reject_below` acceptance floor; one-sided planes; one-sided
// Moller-Trumbore triangles with the area-scaled front-face cull.
static HitInfo nee_nearest(const NeeScene &S, V3 o, V3 d, float rej) {
  float best_t = kInfinite;
  int best = -1;
  for (int i = 0; i < S.ns; ++i) {
    V3 l = row3(S.s_pos, i) - o;
    float tca = dot(l, d);
    float d2 = dot(l, l) - tca * tca;
    float r2 = S.s_rad[i] * S.s_rad[i];
    if (tca < rej || d2 > r2) continue;
    float t = tca - sqrtf(fmaxf(r2 - d2, 1e-12f));
    if (t < rej) continue;
    if (t < best_t) { best_t = t; best = i; }
  }
  for (int i = 0; i < S.np; ++i) {
    V3 n = row3(S.p_nor, i);
    float denom = dot(d, n);
    float num = dot(row3(S.p_pos, i) - o, n);
    float dist = num / (denom == 0.0f ? 5e-7f : denom);
    if (denom > 1e-6f || dist < rej) continue;
    if (dist < best_t) { best_t = dist; best = S.ns + i; }
  }
  for (int i = 0; i < S.nt; ++i) {
    V3 v0 = row3(S.t_v0, i);
    V3 e1 = row3(S.t_v1, i) - v0;
    V3 e2 = row3(S.t_v2, i) - v0;
    V3 pv = cross(d, e2);
    float det = dot(e1, pv);
    float nn = sqrtf(dot(cross(e1, e2), cross(e1, e2)));
    if (det <= 1e-6f * nn) continue;
    float inv_det = 1.0f / (fabsf(det) < 1e-30f ? 1e-30f : det);
    V3 tv = o - v0;
    float u = dot(tv, pv) * inv_det;
    V3 qv = cross(tv, e1);
    float v = dot(d, qv) * inv_det;
    float t = dot(e2, qv) * inv_det;
    if (u < 0.0f || v < 0.0f || u + v > 1.0f || t < rej) continue;
    if (t < best_t) { best_t = t; best = S.ns + S.np + i; }
  }
  HitInfo h;
  h.hit = best >= 0;
  h.prim = h.hit ? best : 0;
  h.point = o + d * (h.hit ? best_t : 0.0f);
  if (!h.hit) { h.normal = {0, 0, 0}; return h; }
  if (best < S.ns) {
    h.normal = normalize(h.point - row3(S.s_pos, best));
  } else if (best < S.ns + S.np) {
    h.normal = row3(S.p_nor, best - S.ns);
  } else {
    int k = best - S.ns - S.np;
    V3 n = cross(row3(S.t_v1, k) - row3(S.t_v0, k),
                 row3(S.t_v2, k) - row3(S.t_v0, k));
    float nn = fmaxf(sqrtf(dot(n, n)), 1e-20f);
    h.normal = n * (1.0f / nn);
  }
  return h;
}

// Duff et al. branchless ONB.
static inline void nee_onb(V3 w, V3 *b1, V3 *b2) {
  float sign = w.z >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (sign + w.z);
  float b = w.x * w.y * a;
  *b1 = {1.0f + sign * w.x * w.x * a, sign * b, -sign * w.x};
  *b2 = {b, sign + w.y * w.y * a, -w.y};
}

static inline float u01(uint32_t *rng) {
  return (float)(sfc32_step(rng) >> 8) * (1.0f / 16777216.0f);
}

extern "C" void ptru_trace_physical_nee(
    const float *s_pos, const float *s_rad, const float *p_pos,
    const float *p_nor, const float *t_v0, const float *t_v1,
    const float *t_v2, const float *color, const float *illum,
    const int32_t *kind, const float *param, int ns, int np, int nt,
    const float *ray_o, const float *ray_d, uint32_t *rng_io,
    float *radiance, int64_t n, int bounces) {
  NeeScene S = {s_pos, s_rad, p_pos, p_nor, t_v0, t_v1, t_v2,
                color, illum, kind, param, ns, np, nt};
  // NEE-sampled emitter list: spheres ++ triangles with illum > 0.
  int n_lights = 0;
  int *lights = new int[ns + nt > 0 ? ns + nt : 1];
  for (int i = 0; i < ns; ++i)
    if (illum[i] > 0.0f) lights[n_lights++] = i;
  for (int i = 0; i < nt; ++i)
    if (illum[ns + np + i] > 0.0f) lights[n_lights++] = ns + i;

  for (int64_t lane = 0; lane < n; ++lane) {
    V3 o = row3(ray_o, (int)lane);
    V3 d = row3(ray_d, (int)lane);
    uint32_t rng[4] = {rng_io[4 * lane], rng_io[4 * lane + 1],
                       rng_io[4 * lane + 2], rng_io[4 * lane + 3]};
    V3 result = {0, 0, 0};
    V3 thpt = {1, 1, 1};
    bool prev_spec = true;
    HitInfo h = nee_nearest(S, o, d, 0.0f);
    for (int bnc = 0; bnc < bounces; ++bnc) {
      if (dot(thpt, thpt) <= 1e-6f || !h.hit) break;
      int pr = h.prim;
      V3 col = row3(S.color, pr);
      float il = S.illum[pr];
      bool is_plane = pr >= ns && pr < ns + np;  // BSDF-only emitter
      if (prev_spec || is_plane)
        result = result + col * thpt * il;

      // BRDF sampling: 3 draws (gen_vec order), corrected lobes.
      float u1 = u01(rng), u2 = u01(rng), u3 = u01(rng);
      int kd = S.kind[pr];
      V3 nd;
      if (kd == 1) {  // glossy mirror
        nd = d - h.normal * (2.0f * dot(d, h.normal));
      } else if (kd == 2) {  // dielectric (Schlick / TIR), branch by u3
        float ior = S.param[pr];
        float ci = -dot(d, h.normal);
        bool inside = ci < 0.0f;
        V3 fn = inside ? h.normal * -1.0f : h.normal;
        float aci = fabsf(ci);
        float eta = inside ? ior : 1.0f / ior;
        float sin2 = eta * eta * fmaxf(1.0f - aci * aci, 0.0f);
        bool tir = sin2 > 1.0f;
        float ct = tir ? 0.0f : sqrtf(fmaxf(1.0f - sin2, 1e-12f));
        float r0 = (1.0f - ior) / (1.0f + ior);
        r0 = r0 * r0;
        float om = 1.0f - aci;
        float fres = r0 + (1.0f - r0) * om * om * om * om * om;
        float f_refl = tir ? 1.0f : fres;
        if (u3 < f_refl) {
          nd = d - fn * (2.0f * dot(d, fn));
        } else {
          V3 tr = d * eta + fn * (eta * aci - ct);
          float tq = fmaxf(sqrtf(dot(tr, tr)), 1e-20f);
          nd = tr * (1.0f / tq);
        }
      } else {  // matte: cosine hemisphere about the normal
        float r = sqrtf(u1);
        float phi = 2.0f * kPi * u2;
        float z = sqrtf(fmaxf(1.0f - u1, 1e-12f));
        V3 b1, b2;
        nee_onb(h.normal, &b1, &b2);
        nd = b1 * (r * cosf(phi)) + b2 * (r * sinf(phi)) + h.normal * z;
      }
      bool is_spec = kd == 1 || kd == 2;

      // NEE: 3 light draws; uniform emitter pick; cone/area sample.
      float us0 = u01(rng), us1 = u01(rng), us2 = u01(rng);
      if (n_lights > 0 && kd == 0) {
        int li = (int)floorf(us0 * (float)n_lights);
        if (li > n_lights - 1) li = n_lights - 1;
        if (li < 0) li = 0;
        int lid = lights[li];
        V3 ldir;
        float inv_pdf_dir;
        float t_l = kInfinite;
        int l_prim;
        if (lid < ns) {  // sphere light: robust cone sample
          V3 c = row3(S.s_pos, lid);
          float rad = S.s_rad[lid];
          V3 to_c = c - h.point;
          float dc2 = dot(to_c, to_c);
          float dc = sqrtf(fmaxf(dc2, 1e-12f));
          float sin2m = rad * rad / fmaxf(dc2, 1e-12f);
          if (sin2m > 1.0f) sin2m = 1.0f;
          bool on = sin2m >= 1.0f;
          float cm = on ? 0.0f : sqrtf(1.0f - sin2m);
          float omc = on ? 1.0f : sin2m / (1.0f + cm);
          float x = us1 * omc;
          float ctt = 1.0f - x;
          float st2 = x * (1.0f + ctt);
          float stt = st2 > 0.0f ? sqrtf(st2) : 0.0f;
          float phi = 2.0f * kPi * us2;
          V3 w = to_c * (1.0f / dc);
          V3 b1, b2;
          nee_onb(w, &b1, &b2);
          ldir = b1 * (stt * cosf(phi)) + b2 * (stt * sinf(phi)) + w * ctt;
          inv_pdf_dir = 2.0f * kPi * omc;
          l_prim = lid;
          // distance to the light along ldir (shade-frame accept)
          V3 l = c - h.point;
          float tca = dot(l, ldir);
          float d2 = dot(l, l) - tca * tca;
          float r2 = rad * rad;
          if (!(tca < kEpsilon || d2 > r2)) {
            float tt = tca - sqrtf(fmaxf(r2 - d2, 1e-12f));
            if (tt >= kEpsilon) t_l = tt;
          }
        } else {  // triangle light: uniform area sample
          int tk = lid - ns;
          V3 v0 = row3(S.t_v0, tk);
          V3 e1 = row3(S.t_v1, tk) - v0;
          V3 e2 = row3(S.t_v2, tk) - v0;
          V3 nvec = cross(e1, e2);
          float nn = fmaxf(sqrtf(dot(nvec, nvec)), 1e-20f);
          V3 nu = nvec * (1.0f / nn);
          float area = 0.5f * nn;
          float r1s = sqrtf(fmaxf(us1, 1e-12f));
          float bu = 1.0f - r1s, bv = us2 * r1s;
          V3 q = v0 + e1 * bu + e2 * bv;
          V3 to_q = q - h.point;
          float d2q = fmaxf(dot(to_q, to_q), 1e-12f);
          ldir = to_q * (1.0f / sqrtf(d2q));
          float cos_l = -dot(ldir, nu);
          float min_d2 = (2.0f * kEpsilon) * (2.0f * kEpsilon);
          inv_pdf_dir =
              (cos_l > 1e-6f && d2q >= min_d2) ? area * cos_l / d2q : 0.0f;
          l_prim = ns + np + tk;
          // MT distance to THIS triangle with the eps floor
          V3 pv = cross(ldir, e2);
          float det = dot(e1, pv);
          if (det > 1e-6f * nn) {
            float inv_det = 1.0f / (fabsf(det) < 1e-30f ? 1e-30f : det);
            V3 tv = h.point - v0;
            float uu = dot(tv, pv) * inv_det;
            V3 qv = cross(tv, e1);
            float vv = dot(ldir, qv) * inv_det;
            float tt = dot(e2, qv) * inv_det;
            if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f &&
                tt >= kEpsilon)
              t_l = tt;
          }
        }
        float inv_pdf =
            inv_pdf_dir > 1e-9f ? inv_pdf_dir * (float)n_lights : 0.0f;
        // Any-occluder window [eps, t_l): sqrt-free spheres, planes,
        // triangles (ops/intersect.py:shadow_occluded).
        bool occ = false;
        if (t_l < kInfinite && inv_pdf > 0.0f) {
          for (int i = 0; i < ns && !occ; ++i) {
            if (i == l_prim) continue;
            V3 l = row3(S.s_pos, i) - h.point;
            float ll = dot(l, l);
            float tca = dot(l, ldir);
            float r2 = S.s_rad[i] * S.s_rad[i];
            float hh = r2 - (ll - tca * tca);
            float a1 = tca - kEpsilon, a2 = tca - t_l;
            if (hh >= 0.0f && a1 >= 0.0f && a1 * a1 >= hh &&
                (a2 < 0.0f || a2 * a2 < hh))
              occ = true;
          }
          for (int i = 0; i < np && !occ; ++i) {
            V3 nrm = row3(S.p_nor, i);
            float denom = dot(ldir, nrm);
            float num = dot(row3(S.p_pos, i) - h.point, nrm);
            float dist = num / (denom == 0.0f ? 5e-7f : denom);
            if (denom <= 1e-6f && dist >= kEpsilon && dist < t_l)
              occ = true;
          }
          for (int i = 0; i < nt && !occ; ++i) {
            if (ns + np + i == l_prim) continue;
            V3 v0 = row3(S.t_v0, i);
            V3 e1 = row3(S.t_v1, i) - v0;
            V3 e2 = row3(S.t_v2, i) - v0;
            float nn = sqrtf(dot(cross(e1, e2), cross(e1, e2)));
            V3 pv = cross(ldir, e2);
            float det = dot(e1, pv);
            if (det <= 1e-6f * nn) continue;
            float inv_det = 1.0f / (fabsf(det) < 1e-30f ? 1e-30f : det);
            V3 tv = h.point - v0;
            float uu = dot(tv, pv) * inv_det;
            V3 qv = cross(tv, e1);
            float vv = dot(ldir, qv) * inv_det;
            float tt = dot(e2, qv) * inv_det;
            if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f &&
                tt >= kEpsilon && tt < t_l)
              occ = true;
          }
        }
        float cos_i = dot(ldir, h.normal);
        if (!occ && t_l < kInfinite && cos_i > 0.0f && inv_pdf > 0.0f) {
          V3 le = row3(S.color, lid < ns ? lid : ns + np + (lid - ns));
          float lil = S.illum[lid < ns ? lid : ns + np + (lid - ns)];
          V3 contrib = thpt * (col * (1.0f / kPi)) * le *
                       (lil * cos_i * inv_pdf);
          result = result + contrib;
        }
      }

      thpt = thpt * col;
      prev_spec = is_spec;
      o = h.point;
      d = nd;
      h = nee_nearest(S, o, d, kEpsilon);
    }
    radiance[3 * lane] = result.x;
    radiance[3 * lane + 1] = result.y;
    radiance[3 * lane + 2] = result.z;
    rng_io[4 * lane] = rng[0];
    rng_io[4 * lane + 1] = rng[1];
    rng_io[4 * lane + 2] = rng[2];
    rng_io[4 * lane + 3] = rng[3];
  }
  delete[] lights;
}
