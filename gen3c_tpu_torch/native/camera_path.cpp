// Camera-path keyframe spline engine (native component).
//
// TPU-rebuild replacement for the reference GUI's camera-path module
// (reference: gui/src/camera_path.cu:90-693 + camera_path.h:40-120 —
// keyframed camera spline with quaternion rotation R, position T, fov and
// timestamp; JSON save/load with {"time": t, "path": [{R,T,fov,...}]};
// smooth playback interpolation). The reference implements it as part of
// the instant-ngp CUDA viewer; here it is a standalone host library with
// a C ABI consumed from Python via ctypes (no pybind11 in this image).
//
// Interpolation: Catmull-Rom over positions/fov, spherical-linear (slerp
// with shortest-path sign fix) over rotations, matching the smooth
// keyframe playback behavior of the GUI.
//
// Build: g++ -O2 -shared -fPIC camera_path.cpp -o libcamera_path.so

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Quat {
  float w, x, y, z;
};

struct Keyframe {
  Quat R;
  float T[3];
  float fov;
  float timestamp;
};

struct CameraPath {
  std::vector<Keyframe> keyframes;
  float play_time = 0.f;
  bool loop = false;
  int spline_order = 3;
};

Quat normalize(const Quat& q) {
  float n = std::sqrt(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  if (n < 1e-12f) return {1.f, 0.f, 0.f, 0.f};
  return {q.w / n, q.x / n, q.y / n, q.z / n};
}

float dot(const Quat& a, const Quat& b) {
  return a.w * b.w + a.x * b.x + a.y * b.y + a.z * b.z;
}

Quat slerp(Quat a, Quat b, float t) {
  a = normalize(a);
  b = normalize(b);
  float d = dot(a, b);
  if (d < 0.f) {  // shortest path
    b = {-b.w, -b.x, -b.y, -b.z};
    d = -d;
  }
  if (d > 0.9995f) {  // nearly parallel: lerp
    Quat r = {a.w + t * (b.w - a.w), a.x + t * (b.x - a.x),
              a.y + t * (b.y - a.y), a.z + t * (b.z - a.z)};
    return normalize(r);
  }
  float theta0 = std::acos(d);
  float theta = theta0 * t;
  float s0 = std::cos(theta) - d * std::sin(theta) / std::sin(theta0);
  float s1 = std::sin(theta) / std::sin(theta0);
  return {s0 * a.w + s1 * b.w, s0 * a.x + s1 * b.x, s0 * a.y + s1 * b.y,
          s0 * a.z + s1 * b.z};
}

float catmull_rom(float p0, float p1, float p2, float p3, float t) {
  float t2 = t * t, t3 = t2 * t;
  return 0.5f * ((2.f * p1) + (-p0 + p2) * t +
                 (2.f * p0 - 5.f * p1 + 4.f * p2 - p3) * t2 +
                 (-p0 + 3.f * p1 - 3.f * p2 + p3) * t3);
}

void quat_to_mat3(const Quat& qin, float m[9]) {
  Quat q = normalize(qin);
  float w = q.w, x = q.x, y = q.y, z = q.z;
  m[0] = 1 - 2 * (y * y + z * z);
  m[1] = 2 * (x * y - w * z);
  m[2] = 2 * (x * z + w * y);
  m[3] = 2 * (x * y + w * z);
  m[4] = 1 - 2 * (x * x + z * z);
  m[5] = 2 * (y * z - w * x);
  m[6] = 2 * (x * z - w * y);
  m[7] = 2 * (y * z + w * x);
  m[8] = 1 - 2 * (x * x + y * y);
}

// rotation matrix (row-major 3x3) -> quaternion
Quat mat3_to_quat(const float m[9]) {
  Quat q;
  float tr = m[0] + m[4] + m[8];
  if (tr > 0.f) {
    float s = std::sqrt(tr + 1.f) * 2.f;
    q.w = 0.25f * s;
    q.x = (m[7] - m[5]) / s;
    q.y = (m[2] - m[6]) / s;
    q.z = (m[3] - m[1]) / s;
  } else if (m[0] > m[4] && m[0] > m[8]) {
    float s = std::sqrt(1.f + m[0] - m[4] - m[8]) * 2.f;
    q.w = (m[7] - m[5]) / s;
    q.x = 0.25f * s;
    q.y = (m[1] + m[3]) / s;
    q.z = (m[2] + m[6]) / s;
  } else if (m[4] > m[8]) {
    float s = std::sqrt(1.f + m[4] - m[0] - m[8]) * 2.f;
    q.w = (m[2] - m[6]) / s;
    q.x = (m[1] + m[3]) / s;
    q.y = 0.25f * s;
    q.z = (m[5] + m[7]) / s;
  } else {
    float s = std::sqrt(1.f + m[8] - m[0] - m[4]) * 2.f;
    q.w = (m[3] - m[1]) / s;
    q.x = (m[2] + m[6]) / s;
    q.y = (m[5] + m[7]) / s;
    q.z = 0.25f * s;
  }
  return normalize(q);
}

Keyframe eval_path(const CameraPath& path, float t) {
  const auto& kf = path.keyframes;
  size_t n = kf.size();
  if (n == 0) return Keyframe{{1, 0, 0, 0}, {0, 0, 0}, 50.f, 0.f};
  if (n == 1 || t <= 0.f) return kf.front();
  if (t >= 1.f) return kf.back();
  float ft = t * (float)(n - 1);
  size_t i = (size_t)ft;
  if (i >= n - 1) i = n - 2;
  float u = ft - (float)i;
  const Keyframe& p1 = kf[i];
  const Keyframe& p2 = kf[i + 1];
  const Keyframe& p0 = kf[i > 0 ? i - 1 : i];
  const Keyframe& p3 = kf[i + 2 < n ? i + 2 : n - 1];

  Keyframe out;
  for (int c = 0; c < 3; c++) {
    out.T[c] = catmull_rom(p0.T[c], p1.T[c], p2.T[c], p3.T[c], u);
  }
  out.fov = catmull_rom(p0.fov, p1.fov, p2.fov, p3.fov, u);
  out.R = slerp(p1.R, p2.R, u);
  out.timestamp = p1.timestamp + u * (p2.timestamp - p1.timestamp);
  return out;
}

// ---- minimal JSON writer/parser for the camera-path schema ----

// Reference GUI interchange schema (gui/src/camera_path.cu:124-133 save,
// nlohmann alphabetical key order; quaternions serialized [x, y, z, w]
// per tiny-cuda-nn vec_json.h:69-82). Files written here load in the
// reference viewer and vice versa.
std::string dump_json(const CameraPath& path) {
  float duration = 0.f;
  for (const Keyframe& k : path.keyframes) {
    if (k.timestamp > duration) duration = k.timestamp;
  }
  std::string s = "{\"duration_seconds\": " + std::to_string(duration) +
                  ", \"loop\": " + (path.loop ? "true" : "false") +
                  ", \"path\": [";
  char buf[512];
  for (size_t i = 0; i < path.keyframes.size(); i++) {
    const Keyframe& k = path.keyframes[i];
    std::snprintf(
        buf, sizeof(buf),
        "%s{\"R\": [%.9g, %.9g, %.9g, %.9g], \"T\": [%.9g, %.9g, %.9g], "
        "\"fov\": %.9g, \"timestamp\": %.9g}",
        i ? ", " : "", k.R.x, k.R.y, k.R.z, k.R.w, k.T[0], k.T[1], k.T[2],
        k.fov, k.timestamp);
    s += buf;
  }
  s += "], \"spline_order\": " + std::to_string(path.spline_order) +
       ", \"time\": " + std::to_string(path.play_time) + "}";
  return s;
}

// tiny tolerant parser: scans numbers after each known key
bool parse_array(const std::string& s, size_t& pos, float* out, int n) {
  pos = s.find('[', pos);
  if (pos == std::string::npos) return false;
  pos++;
  for (int i = 0; i < n; i++) {
    char* end = nullptr;
    out[i] = std::strtof(s.c_str() + pos, &end);
    if (end == s.c_str() + pos) return false;
    pos = end - s.c_str();
    pos = s.find_first_of(",]", pos);
    if (pos == std::string::npos) return false;
    pos++;
  }
  return true;
}

bool parse_number_after(const std::string& s, size_t& pos, const char* key,
                        float* out) {
  size_t k = s.find(key, pos);
  if (k == std::string::npos) return false;
  size_t colon = s.find(':', k);
  if (colon == std::string::npos) return false;
  char* end = nullptr;
  *out = std::strtof(s.c_str() + colon + 1, &end);
  if (end == s.c_str() + colon + 1) return false;
  pos = end - s.c_str();
  return true;
}

bool load_json(CameraPath& path, const std::string& s) {
  path.keyframes.clear();
  size_t pos = 0;
  float t = 0.f;
  size_t tp = 0;
  if (parse_number_after(s, tp, "\"time\"", &t)) path.play_time = t;
  tp = 0;
  if (parse_number_after(s, tp, "\"spline_order\"", &t)) {
    path.spline_order = (int)t;
  }
  size_t lp = s.find("\"loop\"");
  if (lp != std::string::npos) {
    path.loop = s.compare(s.find(':', lp) + 1, 5, " true") == 0 ||
                s.compare(s.find(':', lp) + 1, 4, "true") == 0;
  }
  pos = s.find("\"path\"");
  if (pos == std::string::npos) return false;
  while (true) {
    size_t rk = s.find("\"R\"", pos);
    if (rk == std::string::npos) break;
    Keyframe k{};
    float r4[4], t3[3];
    size_t p = rk;
    if (!parse_array(s, p, r4, 4)) return false;
    size_t tk = s.find("\"T\"", p);
    if (tk == std::string::npos) return false;
    p = tk;
    if (!parse_array(s, p, t3, 3)) return false;
    float fov = 50.f, ts = 0.f;
    size_t fp = p;
    parse_number_after(s, fp, "\"fov\"", &fov);
    size_t sp = p;
    parse_number_after(s, sp, "\"timestamp\"", &ts);
    // file order is [x, y, z, w] (tiny-cuda-nn vec_json.h)
    k.R = {r4[3], r4[0], r4[1], r4[2]};
    std::memcpy(k.T, t3, sizeof(t3));
    k.fov = fov;
    k.timestamp = ts;
    path.keyframes.push_back(k);
    pos = p;
  }
  return !path.keyframes.empty();
}

}  // namespace

extern "C" {

void* camera_path_create() { return new CameraPath(); }

void camera_path_destroy(void* h) { delete (CameraPath*)h; }

int camera_path_n_keyframes(void* h) {
  return (int)((CameraPath*)h)->keyframes.size();
}

void camera_path_clear(void* h) { ((CameraPath*)h)->keyframes.clear(); }

// R as (w,x,y,z), T as (x,y,z)
void camera_path_add_keyframe(void* h, const float* r4, const float* t3,
                              float fov, float timestamp) {
  Keyframe k;
  k.R = {r4[0], r4[1], r4[2], r4[3]};
  std::memcpy(k.T, t3, 3 * sizeof(float));
  k.fov = fov;
  k.timestamp = timestamp;
  ((CameraPath*)h)->keyframes.push_back(k);
}

// add a keyframe from a row-major camera-to-world 3x4 matrix
void camera_path_add_keyframe_m(void* h, const float* c2w34, float fov,
                                float timestamp) {
  float rot[9] = {c2w34[0], c2w34[1], c2w34[2], c2w34[4], c2w34[5],
                  c2w34[6], c2w34[8], c2w34[9], c2w34[10]};
  Keyframe k;
  k.R = mat3_to_quat(rot);
  k.T[0] = c2w34[3];
  k.T[1] = c2w34[7];
  k.T[2] = c2w34[11];
  k.fov = fov;
  k.timestamp = timestamp;
  ((CameraPath*)h)->keyframes.push_back(k);
}

// read back keyframe i as a row-major c2w 3x4 + fov + timestamp
int camera_path_get_keyframe(void* h, int i, float* c2w34_out,
                             float* fov_out, float* timestamp_out) {
  auto& kf = ((CameraPath*)h)->keyframes;
  if (i < 0 || i >= (int)kf.size()) return -1;
  const Keyframe& k = kf[i];
  float m[9];
  quat_to_mat3(k.R, m);
  for (int r = 0; r < 3; r++) {
    for (int c = 0; c < 3; c++) c2w34_out[r * 4 + c] = m[r * 3 + c];
    c2w34_out[r * 4 + 3] = k.T[r];
  }
  *fov_out = k.fov;
  *timestamp_out = k.timestamp;
  return 0;
}

// evaluate at t in [0,1]; writes row-major c2w 3x4 + fov
void camera_path_eval(void* h, float t, float* c2w34_out, float* fov_out) {
  Keyframe k = eval_path(*(CameraPath*)h, t);
  float m[9];
  quat_to_mat3(k.R, m);
  c2w34_out[0] = m[0];
  c2w34_out[1] = m[1];
  c2w34_out[2] = m[2];
  c2w34_out[3] = k.T[0];
  c2w34_out[4] = m[3];
  c2w34_out[5] = m[4];
  c2w34_out[6] = m[5];
  c2w34_out[7] = k.T[1];
  c2w34_out[8] = m[6];
  c2w34_out[9] = m[7];
  c2w34_out[10] = m[8];
  c2w34_out[11] = k.T[2];
  *fov_out = k.fov;
}

// sample n evenly-spaced cameras along the path
void camera_path_sample(void* h, int n, float* c2w34_out, float* fov_out) {
  for (int i = 0; i < n; i++) {
    float t = n > 1 ? (float)i / (float)(n - 1) : 0.f;
    camera_path_eval(h, t, c2w34_out + 12 * i, fov_out + i);
  }
}

int camera_path_save(void* h, const char* filename) {
  std::string s = dump_json(*(CameraPath*)h);
  FILE* f = std::fopen(filename, "wb");
  if (!f) return -1;
  std::fwrite(s.data(), 1, s.size(), f);
  std::fclose(f);
  return 0;
}

int camera_path_load(void* h, const char* filename) {
  FILE* f = std::fopen(filename, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string s(n, '\0');
  size_t read = std::fread(&s[0], 1, n, f);
  std::fclose(f);
  if ((long)read != n) return -2;
  return load_json(*(CameraPath*)h, s) ? 0 : -3;
}

float camera_path_play_time(void* h) { return ((CameraPath*)h)->play_time; }

void camera_path_set_play_time(void* h, float t) {
  ((CameraPath*)h)->play_time = t;
}

}  // extern "C"
