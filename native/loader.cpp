// gsjax native IO: fast 3DGS PLY vertex decoding.
//
// Native counterpart of the reference's ingest hot loop — the
// per-vertex DataView parse in /root/reference/src/loaders/PLYLoader.ts
// :578-712 (and the spirit of its only native component, wasm/wasm.cpp:
// the part of the pipeline too hot for the host language). Decodes
// interleaved float32 PLY rows into SoA arrays ready for device upload:
// log-scales and opacity logits pass through raw (activations happen on
// device), f_rest coefficients are transposed from the file's
// channel-major order to [coeff][channel] — including coefficient 39,
// which the reference's fast path drops (PLYLoader.ts:685).
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// offsets layout (bytes within a vertex row; -1 = absent):
// [0..2]  x y z
// [3..5]  scale_0..2
// [6..9]  rot_0..3 (w x y z)
// [10]    opacity
// [11..13] f_dc_0..2
// [14..58] f_rest_0..44 (channel-major: 15 R, 15 G, 15 B)
int gsjax_parse_ply(const char* buf, size_t nbytes, size_t data_offset,
                    int n, int stride, const int* offsets, int k,
                    float* means, float* log_scales, float* quats,
                    float* sh, float* opacity) {
  if (data_offset + (size_t)n * stride > nbytes) return 1;
  if (!(k == 1 || k == 4 || k == 9 || k == 16)) return 2;
  const int n_rest = k - 1;
  const char* base = buf + data_offset;

  for (int i = 0; i < n; ++i) {
    const char* row = base + (size_t)i * stride;
    float v;
    for (int c = 0; c < 3; ++c) {
      std::memcpy(&v, row + offsets[c], 4);
      means[i * 3 + c] = v;
    }
    for (int c = 0; c < 3; ++c) {
      std::memcpy(&v, row + offsets[3 + c], 4);
      log_scales[i * 3 + c] = v;
    }
    for (int c = 0; c < 4; ++c) {
      std::memcpy(&v, row + offsets[6 + c], 4);
      quats[i * 4 + c] = v;
    }
    std::memcpy(&v, row + offsets[10], 4);
    opacity[i] = v;
    float* shi = sh + (size_t)i * k * 3;
    for (int c = 0; c < 3; ++c) {
      std::memcpy(&v, row + offsets[11 + c], 4);
      shi[c] = v;  // sh[i][0][c]
    }
    for (int c = 0; c < 3; ++c) {
      for (int j = 0; j < n_rest; ++j) {
        const int off = offsets[14 + c * 15 + j];
        if (off < 0) continue;
        std::memcpy(&v, row + off, 4);
        shi[(1 + j) * 3 + c] = v;  // sh[i][1+j][c]
      }
    }
  }
  return 0;
}

// Fast .splat row decode (≙ Scene.setData parse, Scene.ts:126-139):
// 32-byte rows → SoA float outputs. Quaternions are normalized here the
// way the renderer would normalize them anyway.
int gsjax_parse_splat(const char* buf, size_t nbytes, int n,
                      float* positions, float* scales, float* rgba,
                      float* quats) {
  if ((size_t)n * 32 > nbytes) return 1;
  for (int i = 0; i < n; ++i) {
    const char* row = buf + (size_t)i * 32;
    std::memcpy(positions + i * 3, row, 12);
    std::memcpy(scales + i * 3, row + 12, 12);
    const uint8_t* u = reinterpret_cast<const uint8_t*>(row + 24);
    for (int c = 0; c < 4; ++c) rgba[i * 4 + c] = u[c] / 255.0f;
    float q[4];
    float norm2 = 0.f;
    for (int c = 0; c < 4; ++c) {
      q[c] = (u[4 + c] - 128.0f) / 128.0f;
      norm2 += q[c] * q[c];
    }
    float inv = norm2 > 1e-24f ? 1.0f / __builtin_sqrtf(norm2) : 0.f;
    for (int c = 0; c < 4; ++c) quats[i * 4 + c] = q[c] * inv;
  }
  return 0;
}

}  // extern "C"
