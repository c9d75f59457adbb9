// Minimal interactive native viewer (headless display loop).
//
// TPU-rebuild counterpart of the reference GUI's interactive native
// viewer duties (gui/src/testbed.cu:464+ — seeding + point-cloud display
// loop; gui/src/camera_path.cu:693 — gizmo keyframe editor): a
// standalone C++ binary with a stdin command REPL driving an orbit
// camera over a seeded point cloud, rendering frames through
// libpoint_raster (z-buffered splat) into librender_buffer (progressive
// jittered-AA accumulation + tonemapped readout), and editing / saving /
// loading camera-path keyframes in the reference-GUI JSON schema via the
// camera-path spline engine. There is no display server in the target
// environment, so "display" is PPM frame output — every other
// interactive duty (camera control, keyframe gizmo edits, path preview,
// spline playback sampling) is real and scriptable.
//
// Build (done on demand by viewer.py):
//   g++ -O2 -std=c++17 viewer_main.cpp point_raster.cpp render_buffer.cpp
//       camera_path.cpp -o gen3c_viewer
//
// Commands (one per line on stdin; responses on stdout, errors prefixed
// "err "):
//   load <pc.bin>            seed from a GEN3CPC1 point-cloud file
//   orbit <yaw> <pitch>      set orbit angles (radians)
//   dolly <factor>           scale orbit distance
//   target <x> <y> <z>       set orbit target
//   fov <deg>                set camera fov
//   size <w> <h>             set render resolution
//   render <out.ppm> [spp]   render current view (spp>1: jittered AA)
//   kf add                   add keyframe at the current camera
//   kf del <i>               delete keyframe i
//   kf move <i> <dx dy dz>   gizmo-translate keyframe i
//   kf fov <i> <deg>         edit keyframe fov
//   kf time <i> <t>          retime keyframe i
//   kf list                  print keyframes
//   kf save <file.json>      reference-GUI camera-path JSON
//   kf load <file.json>
//   path render <n> <dir>    render n spline frames to dir/frame_%04d.ppm
//   info                     print state summary
//   quit

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <iostream>
#include <sstream>
#include <string>
#include <vector>

// C ABI of the sibling libraries (compiled into this binary)
extern "C" {
void point_raster_frame(const float* points, const uint8_t* colors,
                        int64_t n, const float* w2c, const float* K, int h,
                        int w, float point_radius, uint8_t bg, float znear,
                        uint8_t* out_rgb, float* depth_buf);
void rb_accumulate(float* accum, const float* frame, int64_t n);
void rb_readout(const float* accum, int64_t n, float spp, float exposure,
                int srgb_transfer, uint8_t* out_u8);
void* camera_path_create();
void camera_path_destroy(void* h);
void camera_path_add_keyframe_m(void* h, const float* c2w34, float fov,
                                float timestamp);
int camera_path_get_keyframe(void* h, int i, float* c2w34_out,
                             float* fov_out, float* timestamp_out);
int camera_path_n_keyframes(void* h);
void camera_path_clear(void* h);
void camera_path_sample(void* h, int n, float* c2w34_out, float* fov_out);
int camera_path_save(void* h, const char* filename);
int camera_path_load(void* h, const char* filename);
}

namespace {

struct Kf {
  float c2w[12];
  float fov;
  float t;
};

struct Viewer {
  std::vector<float> points;   // (n, 3)
  std::vector<uint8_t> colors; // (n, 3)
  int64_t n_points = 0;
  // orbit camera (viewer.html:206 defaults)
  float target[3] = {0.f, 0.f, 2.f};
  float dist = 3.f, yaw = 0.f, pitch = 0.f, fov = 50.f;
  int width = 256, height = 144;
  std::vector<Kf> keyframes;
};

// OpenCV-convention orbit c2w — the same math as viewer.html:150-159
// and serving/client.py orbit_c2w, so all three authoring surfaces agree
void orbit_c2w(const Viewer& v, float c2w[12]) {
  float eye[3] = {v.target[0] + v.dist * std::sin(v.yaw) * std::cos(v.pitch),
                  v.target[1] + v.dist * std::sin(v.pitch),
                  v.target[2] - v.dist * std::cos(v.yaw) * std::cos(v.pitch)};
  float z[3] = {v.target[0] - eye[0], v.target[1] - eye[1],
                v.target[2] - eye[2]};
  float zl = std::sqrt(z[0] * z[0] + z[1] * z[1] + z[2] * z[2]);
  if (zl < 1e-12f) zl = 1.f;
  for (int i = 0; i < 3; ++i) z[i] /= zl;
  const float down[3] = {0.f, 1.f, 0.f};
  float x[3] = {down[1] * z[2] - down[2] * z[1],
                down[2] * z[0] - down[0] * z[2],
                down[0] * z[1] - down[1] * z[0]};
  float xl = std::sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2]);
  if (xl < 1e-12f) xl = 1.f;
  for (int i = 0; i < 3; ++i) x[i] /= xl;
  float y[3] = {z[1] * x[2] - z[2] * x[1], z[2] * x[0] - z[0] * x[2],
                z[0] * x[1] - z[1] * x[0]};
  for (int r = 0; r < 3; ++r) {
    c2w[r * 4 + 0] = x[r];
    c2w[r * 4 + 1] = y[r];
    c2w[r * 4 + 2] = z[r];
    c2w[r * 4 + 3] = (r == 0 ? eye[0] : r == 1 ? eye[1] : eye[2]);
  }
}

// rigid inverse: w2c (4x4 row-major) from c2w (3x4 row-major)
void invert_c2w(const float c2w[12], float w2c[16]) {
  std::memset(w2c, 0, 16 * sizeof(float));
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) w2c[r * 4 + c] = c2w[c * 4 + r];  // R^T
  }
  for (int r = 0; r < 3; ++r) {
    w2c[r * 4 + 3] = -(w2c[r * 4 + 0] * c2w[3] + w2c[r * 4 + 1] * c2w[7] +
                       w2c[r * 4 + 2] * c2w[11]);
  }
  w2c[15] = 1.f;
}

bool load_pointcloud(Viewer& v, const std::string& path) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 ||
      std::memcmp(magic, "GEN3CPC1", 8) != 0) {
    std::fclose(f);
    return false;
  }
  int64_t n = 0;
  if (std::fread(&n, sizeof(n), 1, f) != 1 || n <= 0 || n > (1ll << 32)) {
    std::fclose(f);
    return false;
  }
  v.points.resize((size_t)n * 3);
  v.colors.resize((size_t)n * 3);
  bool ok =
      std::fread(v.points.data(), sizeof(float), (size_t)n * 3, f) ==
          (size_t)n * 3 &&
      std::fread(v.colors.data(), 1, (size_t)n * 3, f) == (size_t)n * 3;
  std::fclose(f);
  if (ok) v.n_points = n;
  return ok;
}

// render the view for camera c2w/fov with spp jittered-principal-point
// accumulation through the render buffer (progressive AA — the
// CudaRenderBuffer spp role)
void render_view(const Viewer& v, const float c2w[12], float fov_deg,
                 int spp, std::vector<uint8_t>& out) {
  const int W = v.width, H = v.height;
  const size_t npx = (size_t)W * H * 3;
  out.assign(npx, 0);
  std::vector<float> depth((size_t)W * H);
  std::vector<uint8_t> frame(npx);
  std::vector<float> framef(npx), accum(npx, 0.f);
  float w2c[16];
  invert_c2w(c2w, w2c);
  const float f = 0.5f * W / std::tan(fov_deg * (float)M_PI / 360.f);
  if (spp < 1) spp = 1;
  for (int s = 0; s < spp; ++s) {
    // deterministic sub-pixel jitter (s/spp rotated lattice)
    const float jx = spp > 1 ? ((s * 0.618034f) - std::floor(s * 0.618034f)) - 0.5f : 0.f;
    const float jy = spp > 1 ? ((s * 0.381966f) - std::floor(s * 0.381966f)) - 0.5f : 0.f;
    const float K[9] = {f, 0.f, 0.5f * W + jx, 0.f, f, 0.5f * H + jy,
                        0.f, 0.f, 1.f};
    point_raster_frame(v.points.data(), v.colors.data(), v.n_points, w2c, K,
                       H, W, 1.0f, 0, 1e-4f, frame.data(), depth.data());
    for (size_t i = 0; i < npx; ++i) framef[i] = frame[i] / 255.f;
    rb_accumulate(accum.data(), framef.data(), (int64_t)npx);
  }
  // linear readout (colors are stored display-referred already)
  rb_readout(accum.data(), (int64_t)npx, (float)spp, 0.f, 0, out.data());
}

bool write_ppm(const std::string& path, const uint8_t* rgb, int w, int h) {
  FILE* f = std::fopen(path.c_str(), "wb");
  if (!f) return false;
  std::fprintf(f, "P6\n%d %d\n255\n", w, h);
  const bool ok = std::fwrite(rgb, 1, (size_t)w * h * 3, f) ==
                  (size_t)w * h * 3;
  std::fclose(f);
  return ok;
}

void* build_path(const Viewer& v) {
  void* h = camera_path_create();
  for (const Kf& k : v.keyframes)
    camera_path_add_keyframe_m(h, k.c2w, k.fov, k.t);
  return h;
}

}  // namespace

int main(int argc, char** argv) {
  Viewer v;
  std::string line;
  if (argc > 1 && load_pointcloud(v, argv[1]))
    std::printf("gen3c native viewer ready (%lld points)\n",
                (long long)v.n_points);
  else
    std::printf("gen3c native viewer ready\n");
  std::fflush(stdout);
  while (std::getline(std::cin, line)) {
    std::istringstream ss(line);
    std::string cmd;
    ss >> cmd;
    if (cmd.empty()) continue;
    if (cmd == "quit" || cmd == "exit") break;
    if (cmd == "load") {
      std::string path;
      ss >> path;
      if (load_pointcloud(v, path))
        std::printf("ok loaded %lld points\n", (long long)v.n_points);
      else
        std::printf("err cannot load %s\n", path.c_str());
    } else if (cmd == "orbit") {
      ss >> v.yaw >> v.pitch;
      std::printf("ok yaw=%g pitch=%g\n", v.yaw, v.pitch);
    } else if (cmd == "dolly") {
      float fct = 1.f;
      ss >> fct;
      v.dist *= fct;
      std::printf("ok dist=%g\n", v.dist);
    } else if (cmd == "target") {
      ss >> v.target[0] >> v.target[1] >> v.target[2];
      std::printf("ok\n");
    } else if (cmd == "fov") {
      ss >> v.fov;
      std::printf("ok fov=%g\n", v.fov);
    } else if (cmd == "size") {
      ss >> v.width >> v.height;
      if (v.width < 1 || v.height < 1 || v.width > 8192 || v.height > 8192) {
        v.width = 256;
        v.height = 144;
        std::printf("err bad size, reset to 256x144\n");
      } else {
        std::printf("ok %dx%d\n", v.width, v.height);
      }
    } else if (cmd == "render") {
      std::string out;
      int spp = 1;
      ss >> out >> spp;
      float c2w[12];
      orbit_c2w(v, c2w);
      std::vector<uint8_t> rgb;
      render_view(v, c2w, v.fov, spp, rgb);
      if (write_ppm(out, rgb.data(), v.width, v.height))
        std::printf("ok rendered %s (%dx%d spp=%d)\n", out.c_str(), v.width,
                    v.height, spp < 1 ? 1 : spp);
      else
        std::printf("err cannot write %s\n", out.c_str());
    } else if (cmd == "kf") {
      std::string sub;
      ss >> sub;
      if (sub == "add") {
        Kf k;
        orbit_c2w(v, k.c2w);
        k.fov = v.fov;
        k.t = (float)v.keyframes.size();
        v.keyframes.push_back(k);
        std::printf("ok keyframe %zu added\n", v.keyframes.size() - 1);
      } else if (sub == "del") {
        size_t i = 0;
        ss >> i;
        if (i < v.keyframes.size()) {
          v.keyframes.erase(v.keyframes.begin() + i);
          std::printf("ok keyframe %zu deleted\n", i);
        } else {
          std::printf("err no keyframe %zu\n", i);
        }
      } else if (sub == "move") {
        size_t i = 0;
        float d[3] = {0, 0, 0};
        ss >> i >> d[0] >> d[1] >> d[2];
        if (i < v.keyframes.size()) {
          v.keyframes[i].c2w[3] += d[0];
          v.keyframes[i].c2w[7] += d[1];
          v.keyframes[i].c2w[11] += d[2];
          std::printf("ok keyframe %zu moved\n", i);
        } else {
          std::printf("err no keyframe %zu\n", i);
        }
      } else if (sub == "fov") {
        size_t i = 0;
        float fd = 50.f;
        ss >> i >> fd;
        if (i < v.keyframes.size()) {
          v.keyframes[i].fov = fd;
          std::printf("ok\n");
        } else {
          std::printf("err no keyframe %zu\n", i);
        }
      } else if (sub == "time") {
        size_t i = 0;
        float t = 0.f;
        ss >> i >> t;
        if (i < v.keyframes.size()) {
          v.keyframes[i].t = t;
          std::printf("ok\n");
        } else {
          std::printf("err no keyframe %zu\n", i);
        }
      } else if (sub == "list") {
        for (size_t i = 0; i < v.keyframes.size(); ++i) {
          const Kf& k = v.keyframes[i];
          std::printf("kf %zu T=(%g, %g, %g) fov=%g t=%g\n", i, k.c2w[3],
                      k.c2w[7], k.c2w[11], k.fov, k.t);
        }
        std::printf("ok %zu keyframes\n", v.keyframes.size());
      } else if (sub == "save") {
        std::string path;
        ss >> path;
        void* h = build_path(v);
        int rc = camera_path_save(h, path.c_str());
        camera_path_destroy(h);
        std::printf(rc == 0 ? "ok saved %s\n" : "err cannot save %s\n",
                    path.c_str());
      } else if (sub == "load") {
        std::string path;
        ss >> path;
        void* h = camera_path_create();
        if (camera_path_load(h, path.c_str()) == 0) {
          v.keyframes.clear();
          int n = camera_path_n_keyframes(h);
          for (int i = 0; i < n; ++i) {
            Kf k;
            camera_path_get_keyframe(h, i, k.c2w, &k.fov, &k.t);
            v.keyframes.push_back(k);
          }
          std::printf("ok loaded %d keyframes\n", n);
        } else {
          std::printf("err cannot load %s\n", path.c_str());
        }
        camera_path_destroy(h);
      } else {
        std::printf("err unknown kf command '%s'\n", sub.c_str());
      }
    } else if (cmd == "path") {
      std::string sub;
      ss >> sub;
      if (sub == "render") {
        int n = 0;
        std::string dir;
        ss >> n >> dir;
        if (n < 1 || n > 100000 || v.keyframes.empty()) {
          std::printf("err need keyframes and 1<=n<=100000\n");
        } else {
          void* h = build_path(v);
          std::vector<float> c2ws((size_t)n * 12), fovs((size_t)n);
          camera_path_sample(h, n, c2ws.data(), fovs.data());
          camera_path_destroy(h);
          std::vector<uint8_t> rgb;
          bool ok = true;
          for (int i = 0; i < n && ok; ++i) {
            render_view(v, c2ws.data() + (size_t)i * 12, fovs[i], 1, rgb);
            char name[64];
            std::snprintf(name, sizeof(name), "/frame_%04d.ppm", i);
            ok = write_ppm(dir + name, rgb.data(), v.width, v.height);
          }
          std::printf(ok ? "ok path rendered %d frames to %s\n"
                         : "err write failed in %s (%d frames)\n",
                      n, dir.c_str());
        }
      } else {
        std::printf("err unknown path command '%s'\n", sub.c_str());
      }
    } else if (cmd == "info") {
      std::printf(
          "info points=%lld size=%dx%d dist=%g yaw=%g pitch=%g fov=%g "
          "keyframes=%zu\n",
          (long long)v.n_points, v.width, v.height, v.dist, v.yaw, v.pitch,
          v.fov, v.keyframes.size());
    } else {
      std::printf("err unknown command '%s'\n", cmd.c_str());
    }
    std::fflush(stdout);
  }
  return 0;
}
