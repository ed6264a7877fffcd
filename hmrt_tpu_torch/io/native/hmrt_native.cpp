// Host library of hmrt_tpu_torch: the fBm terrain evaluator and the PNG
// scanline unfilter, with a plain C interface for ctypes.
//
// Both reproduce numpy specs of the package bit for bit:
//   - terrain_fbm: io/heightmap.py::procedural_terrain_reference;
//   - png_unfilter: io/image.py::_unfilter.
// Build with -ffp-contract=off: a contracted multiply-add rounds once where
// numpy rounds twice, and the terrain would no longer equal its spec.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

static inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

// Unfilter PNG scanlines: raw holds h rows of (1 filter byte + stride)
// bytes, out receives h * stride bytes. Returns 0, or -1 on a filter byte
// outside 0-4.
int png_unfilter(const uint8_t* raw, uint8_t* out, int64_t h, int64_t stride,
                 int bpp) {
    const uint8_t* prev = nullptr;
    for (int64_t y = 0; y < h; y++) {
        uint8_t ft = raw[y * (stride + 1)];
        const uint8_t* line = raw + y * (stride + 1) + 1;
        uint8_t* cur = out + y * stride;
        switch (ft) {
            case 0:
                memcpy(cur, line, stride);
                break;
            case 1:  // Sub
                for (int64_t i = 0; i < stride; i++) {
                    uint8_t a = i >= bpp ? cur[i - bpp] : 0;
                    cur[i] = (uint8_t)(line[i] + a);
                }
                break;
            case 2:  // Up
                for (int64_t i = 0; i < stride; i++) {
                    uint8_t b = prev ? prev[i] : 0;
                    cur[i] = (uint8_t)(line[i] + b);
                }
                break;
            case 3:  // Average
                for (int64_t i = 0; i < stride; i++) {
                    int a = i >= bpp ? cur[i - bpp] : 0;
                    int b = prev ? prev[i] : 0;
                    cur[i] = (uint8_t)(line[i] + ((a + b) >> 1));
                }
                break;
            case 4:  // Paeth
                for (int64_t i = 0; i < stride; i++) {
                    int a = i >= bpp ? cur[i - bpp] : 0;
                    int b = prev ? prev[i] : 0;
                    int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                    cur[i] = (uint8_t)(line[i] + paeth(a, b, c));
                }
                break;
            default:
                return -1;
        }
        prev = cur;
    }
    return 0;
}

// fBm value-noise accumulation into out (n x n f32), octave by octave in
// the spec's order. grids holds the octave lattices flat, octave o's
// (cells[o]+1)^2 values from offs[o]; amps are the f64 octave weights.
// In the spec `f = t - i` is f32 minus int32, which numpy promotes to f64,
// so the interpolation runs in double and rounds to f32 once per octave,
// at the in-place `acc += amp * layer`. Rows run in parallel. Returns 0.
int terrain_fbm(const float* grids, const int64_t* offs, const int64_t* cells,
                const double* amps, int64_t octaves, int64_t n, int ridged,
                float* out) {
    auto rows = [&](int64_t ybeg, int64_t yend) {
        for (int64_t y = ybeg; y < yend; y++) {
            float* row = out + y * n;
            for (int64_t x = 0; x < n; x++) row[x] = 0.0f;
            for (int64_t o = 0; o < octaves; o++) {
                const float* g = grids + offs[o];
                const int64_t c = cells[o];
                const int64_t stride = c + 1;
                // np.linspace(0, c, n, endpoint=False, dtype=f32) is
                // arange(n) * (c / n) in f64, cast to f32
                const double delta = (double)c / (double)n;
                const float ty = (float)((double)y * delta);
                int64_t iy = (int64_t)ty;
                if (iy > c - 1) iy = c - 1;
                const double fy = (double)ty - (double)iy;
                const double sy = fy * fy * (3.0 - 2.0 * fy);
                const double omsy = 1.0 - sy;
                const float* g0 = g + iy * stride;
                const float* g1 = g + (iy + 1) * stride;
                const double amp = amps[o];
                for (int64_t x = 0; x < n; x++) {
                    const float tx = (float)((double)x * delta);
                    int64_t ix = (int64_t)tx;
                    if (ix > c - 1) ix = c - 1;
                    const double fx = (double)tx - (double)ix;
                    const double sx = fx * fx * (3.0 - 2.0 * fx);
                    const double omsx = 1.0 - sx;
                    // the spec's element-wise order, additions from the left:
                    // g00*(1-sy)*(1-sx) + g10*sy*(1-sx) + g01*(1-sy)*sx + g11*sy*sx
                    const double t1 = ((double)g0[ix] * omsy) * omsx;
                    const double t2 = ((double)g1[ix] * sy) * omsx;
                    const double t3 = ((double)g0[ix + 1] * omsy) * sx;
                    const double t4 = ((double)g1[ix + 1] * sy) * sx;
                    double v = ((t1 + t2) + t3) + t4;
                    if (ridged) v = 1.0 - fabs(v);
                    // `acc += amp * layer`: the sum in f64, stored as f32
                    row[x] = (float)((double)row[x] + amp * v);
                }
            }
        }
    };
    unsigned hw = std::thread::hardware_concurrency();
    int64_t nthreads = (int64_t)std::min<unsigned>(hw ? hw : 1, 16);
    nthreads = std::max<int64_t>(1, std::min(nthreads, n));
    if (nthreads == 1 || n < 256) {
        rows(0, n);
        return 0;
    }
    std::vector<std::thread> pool;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int64_t t = 0; t < nthreads; t++) {
        int64_t y0 = t * chunk, y1 = std::min(n, y0 + chunk);
        if (y0 >= y1) break;
        pool.emplace_back(rows, y0, y1);
    }
    for (auto& th : pool) th.join();
    return 0;
}

}  // extern "C"
