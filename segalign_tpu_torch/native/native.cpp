// Native host runtime for segalign_tpu.
//
// TPU-native equivalent of the reference's host/thrust support code:
//   - HSP dedup sort/unique chains, literal translations of the thrust
//     comparators and unique_copy semantics in
//     reference/src/seed_filter.cu:47-108,769-782 and
//     reference/repeat_masker_src/seed_filter.cu:47-135,819-831
//   - byte encoding / reverse complement (compress_string equivalents)
//
// Built as a plain shared library, bound via ctypes (no pybind11 in image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

struct SP {
    int64_t rs;
    int64_t qs;
    int64_t ln;
    int64_t sc;
};

static inline uint32_t diag_u32(const SP& x) {
    return (uint32_t)((uint64_t)x.rs - (uint64_t)x.qs);
}

// ---- pairwise comparators (src/seed_filter.cu:47-108) ----------------------

static bool hsp_comp(const SP& x, const SP& y) {
    uint32_t dx = diag_u32(x), dy = diag_u32(y);
    if (dx != dy) return dx < dy;
    if (x.rs != y.rs) return x.rs < y.rs;
    if (x.ln != y.ln) return x.ln < y.ln;
    return x.sc > y.sc;
}

static bool hsp_comp_lastz(const SP& x, const SP& y) {
    if (x.qs != y.qs) return x.qs < y.qs;
    if (x.rs != y.rs) return x.rs < y.rs;
    if (x.ln != y.ln) return x.ln < y.ln;
    return x.sc > y.sc;
}

static bool hsp_equal(const SP& x, const SP& y) {
    if (diag_u32(x) != diag_u32(y)) return false;
    return (x.rs >= y.rs && x.rs + x.ln <= y.rs + y.ln) ||
           (y.rs >= x.rs && y.rs + y.ln <= x.rs + x.ln);
}

// ---- repeat-masker comparators (repeat_masker_src/seed_filter.cu:47-135) ---

static bool rm_comp(const SP& x, const SP& y) {
    if (x.qs != y.qs) return x.qs < y.qs;
    if (x.ln != y.ln) return x.ln > y.ln;
    if (x.rs != y.rs) return x.rs < y.rs;
    return x.sc > y.sc;
}

static bool rm_exact_equal(const SP& x, const SP& y) {
    return x.rs == y.rs && x.qs == y.qs && x.ln == y.ln && x.sc == y.sc;
}

static bool rm_diag_comp(const SP& x, const SP& y) {
    uint32_t dx = diag_u32(x), dy = diag_u32(y);
    if (dx != dy) return dx < dy;
    if (x.rs != y.rs) return x.rs < y.rs;
    if (x.qs != y.qs) return x.qs < y.qs;
    return x.sc > y.sc;
}

static bool rm_final_comp(const SP& x, const SP& y) {
    if (x.qs != y.qs) return x.qs < y.qs;
    if (x.sc != y.sc) return x.sc > y.sc;
    return x.rs > y.rs;
}

// thrust::unique_copy semantics: keep an element unless equal to the last
// KEPT element.
template <typename EQ>
static size_t unique_chain(std::vector<SP>& v, EQ eq) {
    size_t m = 0;
    for (size_t i = 0; i < v.size(); i++) {
        if (m == 0 || !eq(v[m - 1], v[i])) v[m++] = v[i];
    }
    v.resize(m);
    return m;
}

static void load(std::vector<SP>& v, const int64_t* rs, const int64_t* qs,
                 const int64_t* ln, const int64_t* sc, int64_t n) {
    v.resize(n);
    for (int64_t i = 0; i < n; i++) v[i] = SP{rs[i], qs[i], ln[i], sc[i]};
}

static void store(const std::vector<SP>& v, int64_t* rs, int64_t* qs,
                  int64_t* ln, int64_t* sc) {
    for (size_t i = 0; i < v.size(); i++) {
        rs[i] = v[i].rs; qs[i] = v[i].qs; ln[i] = v[i].ln; sc[i] = v[i].sc;
    }
}

extern "C" {

// In-place dedup; returns the kept count.
int64_t dedup_pairwise(int64_t* rs, int64_t* qs, int64_t* ln, int64_t* sc,
                       int64_t n) {
    std::vector<SP> v;
    load(v, rs, qs, ln, sc, n);
    std::stable_sort(v.begin(), v.end(), hsp_comp);
    unique_chain(v, hsp_equal);
    std::stable_sort(v.begin(), v.end(), hsp_comp_lastz);
    store(v, rs, qs, ln, sc);
    return (int64_t)v.size();
}

int64_t dedup_rm(int64_t* rs, int64_t* qs, int64_t* ln, int64_t* sc,
                 int64_t n) {
    std::vector<SP> v;
    load(v, rs, qs, ln, sc, n);
    std::stable_sort(v.begin(), v.end(), rm_comp);
    unique_chain(v, rm_exact_equal);
    std::stable_sort(v.begin(), v.end(), rm_diag_comp);
    unique_chain(v, hsp_equal);
    std::stable_sort(v.begin(), v.end(), rm_final_comp);
    store(v, rs, qs, ln, sc);
    return (int64_t)v.size();
}

// ---- encoding (compress_string / RevComp equivalents) ----------------------

static uint8_t ENC[256];
static uint8_t COMP[8] = {3, 2, 1, 0, 4, 5, 6, 7};

__attribute__((constructor)) static void init_tables() {
    memset(ENC, 6, sizeof(ENC));  // X_NT
    ENC[(unsigned char)'A'] = 0; ENC[(unsigned char)'C'] = 1;
    ENC[(unsigned char)'G'] = 2; ENC[(unsigned char)'T'] = 3;
    ENC[(unsigned char)'a'] = 4; ENC[(unsigned char)'c'] = 4;
    ENC[(unsigned char)'g'] = 4; ENC[(unsigned char)'t'] = 4;
    ENC[(unsigned char)'n'] = 5; ENC[(unsigned char)'N'] = 5;
    ENC[(unsigned char)'&'] = 7;
}

void encode_bytes(const uint8_t* src, uint8_t* dst, int64_t n) {
    for (int64_t i = 0; i < n; i++) dst[i] = ENC[src[i]];
}

void revcomp_codes(const uint8_t* src, uint8_t* dst, int64_t n) {
    for (int64_t i = 0; i < n; i++) dst[i] = COMP[src[n - 1 - i] & 7];
}

// ---- lazy entropy counts ---------------------------------------------------
// Per-HSP A/C/G/T match counts over the FINAL extension extent
// [rs, rs+ln] x [qs, qs+ln] (ln+1 positions, both endpoints included).
// oracle/scan_spec.py: the counts the device kernels used to track
// incrementally are a pure function of the final extents, so the host
// recomputes them here for entropy-band candidates only and the device
// skips the bookkeeping entirely (with_counts=False kernels).
void entropy_counts(const uint8_t* ref, int64_t ref_len, const uint8_t* q,
                    int64_t q_len, const int64_t* rs, const int64_t* qs,
                    const int64_t* ln, int64_t n, int64_t* out /* n x 4 */) {
    for (int64_t i = 0; i < n; i++) {
        int64_t c0 = 0, c1 = 0, c2 = 0, c3 = 0;
        int64_t r0 = rs[i], q0 = qs[i];
        int64_t end = ln[i] + 1;
        if (r0 < 0 || q0 < 0 || r0 + end > ref_len || q0 + end > q_len)
            end = 0;  // defensive: malformed extents count nothing
        const uint8_t* rp = ref + r0;
        const uint8_t* qp = q + q0;
        for (int64_t j = 0; j < end; j++) {
            uint8_t a = rp[j];
            if (a == qp[j]) {
                switch (a) {
                    case 0: c0++; break;
                    case 1: c1++; break;
                    case 2: c2++; break;
                    case 3: c3++; break;
                    default: break;
                }
            }
        }
        out[i * 4 + 0] = c0; out[i * 4 + 1] = c1;
        out[i * 4 + 2] = c2; out[i * 4 + 3] = c3;
    }
}

}  // extern "C"
