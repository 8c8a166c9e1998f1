// nbodycore — native host-side runtime pieces of nbodyax.
//
// The reference implements its host layer in C++ (RNG at
// /root/reference/include/jbutil.h:514-562, scene init at
// /root/reference/src/nbody.cu:406-416, PGM writer at
// the reference's src/nbody.cu:350-371). This library provides the
// framework's native equivalents:
//
//  - the Numerical-Recipes "Ranq1-style" combined LCG/xorshift/MWC generator
//    (public-domain constants), bit-identical to the reference stream so
//    seeded scenes reproduce exactly;
//  - batch scene generation (the recurrence is inherently sequential: for
//    N=4M that is 16M dependent draws — native code makes init instant where
//    Python takes tens of seconds);
//  - a binary P5/PGM frame encoder for the async frame writer.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

struct Randgen {
    // Combined generator: 64-bit LCG (u), 64-bit xorshift (v),
    // 32-bit multiply-with-carry (w). Constants are the published
    // Numerical Recipes values (same ones jbutil uses).
    uint64_t u, v, w;

    explicit Randgen(uint64_t s) { seed(s); }

    void seed(uint64_t s) {
        v = 4101842887655102017ULL;
        w = 1;
        u = s ^ v;
        ival64();
        v = u;
        ival64();
        w = v;
        ival64();
    }

    inline void advance() {
        u = u * 2862933555777941757ULL + 7046029254386353087ULL;
        v ^= v >> 17;
        v ^= v << 31;
        v ^= v >> 8;
        w = 4294957665ULL * (w & 0xffffffffULL) + (w >> 32);
    }

    inline uint64_t ival64() {
        advance();
        uint64_t x = u ^ (u << 21);
        x ^= x >> 35;
        x ^= x << 4;
        return (x + v) ^ w;
    }

    inline double fval() { return 5.42101086242752217E-20 * ival64(); }

    inline double fval(double a, double b) { return fval() * (b - a) + a; }
};

}  // namespace

extern "C" {

// Raw uint64 stream (for bit-exactness tests against the Python port).
void nbx_ival64_sequence(uint64_t seed, int64_t n, uint64_t* out) {
    Randgen g(seed);
    for (int64_t i = 0; i < n; ++i) out[i] = g.ival64();
}

// Reference scene init (nbody.cu:406-416): per body draw x, y, mass, radius;
// each value computed in double and narrowed to float on store, with the
// mass/radius bounds pre-narrowed to float (they live in a float ConfigData,
// nbodyConfig.h:9-12). Velocities start at zero (nbody.cu:413).
void nbx_scene_fill(uint64_t seed, int64_t n,
                    int64_t field_width, int64_t field_height,
                    float min_mass, float max_mass,
                    float min_radius, float max_radius,
                    float* pos /* [n][2] */, float* vel /* [n][2] */,
                    float* mass /* [n] */, float* radius /* [n] */) {
    Randgen g(seed);
    const double dw = 2.0 * static_cast<double>(field_width);
    const double dh = 2.0 * static_cast<double>(field_height);
    for (int64_t i = 0; i < n; ++i) {
        pos[2 * i + 0] = static_cast<float>(
            g.fval(0.0, dw) - static_cast<double>(field_width));
        pos[2 * i + 1] = static_cast<float>(
            g.fval(0.0, dh) - static_cast<double>(field_height));
        mass[i] = static_cast<float>(g.fval(min_mass, max_mass));
        radius[i] = static_cast<float>(g.fval(min_radius, max_radius));
        vel[2 * i + 0] = 0.0f;
        vel[2 * i + 1] = 0.0f;
    }
}

// Binary P5 writer, header layout identical to saveImageToDisk
// (nbody.cu:359). Returns 0 on success, -1 on IO failure.
int nbx_write_pgm(const char* path, const uint8_t* data, int32_t width,
                  int32_t height) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    if (fprintf(f, "P5\n%d %d\n255\n", width, height) < 0) {
        fclose(f);
        return -1;
    }
    size_t total = static_cast<size_t>(width) * static_cast<size_t>(height);
    size_t written = fwrite(data, 1, total, f);
    if (fclose(f) != 0 || written != total) return -1;
    return 0;
}

int32_t nbx_abi_version(void) { return 1; }

}  // extern "C"
