// Native gapped ydrop extension (LASTZ-delegation replacement).
//
// The reference performs gapped extension by shelling out to LASTZ
// (reference/scripts/run_segalign:112-117); when lastz is not
// installed, segalign_tpu uses this native implementation instead: an
// adaptive-banded affine-gap DP with ydrop pruning, extended left+right from
// each anchor, functionally equivalent to lastz's gapped stage (NOT
// byte-identical; delegation mode remains the byte-compat path).
//
// Alphabet here is the gapped-stage coding: A=0 C=1 G=2 T=3 (case folded),
// N=4, other=5, '&' separator=6 (impassable wall).
//
// Memory: per row we retain only the backpointer bytes (1 B/cell, in a
// growable arena) plus the band offset; cell scores roll as int32
// structure-of-arrays bands. Pruned cells are fully zapped so no later
// transition can source from them, keeping traceback inside stored bands.
//
// Round-4 rewrite for throughput (same cell recurrence, bit-identical
// results): the per-row work splits into a vectorizable pass computing the
// M (diagonal) and I (query-gap) states — both depend only on the previous
// row — and a tight serial pass for the D chain + ydrop prune, whose
// left-to-right dependence (D sources the just-zapped previous cell, and
// `best` rises as the row is scanned) is semantic and cannot be
// parallelized. Scores are int32 (score magnitude is bounded by
// 91 * extension length; callers longer than MAX_I32_EXT fall back to the
// original int64 path, kept below). All scratch is thread_local and reused
// across calls: this DP runs under the gapped stage's host thread pool,
// and per-row heap allocation was ~40% of runtime. Measured (bench-shaped
// 85%-identity extensions, profile_gapped.py): 6.0 -> 0.5 ms per kb of
// alignment, 12x.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t NEG_INF = INT64_MIN / 4;
constexpr int32_t NEG32 = INT32_MIN / 4;
constexpr uint8_t BP_M_FROM_I = 0x01;  // M's diagonal predecessor was I
constexpr uint8_t BP_M_FROM_D = 0x02;  // ... was D (else M)
constexpr uint8_t BP_I_FROM_I = 0x10;  // I extends an existing I
constexpr uint8_t BP_D_FROM_D = 0x20;  // D extends an existing D

// int32 scores are safe while 91 * (max extension) stays far from
// INT32_MAX/4; beyond this the original int64 path runs instead.
constexpr int64_t MAX_I32_EXT = 4'000'000;

struct ExtResult {
    int64_t score = 0;
    int64_t r_ext = 0;
    int64_t q_ext = 0;
    std::vector<uint8_t> ops;  // 'M','I','D', ordered anchor -> far end
};

struct Dp {
    const uint8_t* ref;
    int64_t ref_len;
    const uint8_t* query;
    int64_t query_len;
    const int64_t* sub;  // 8x8 row-major
    int64_t gap_open, gap_extend, ydrop;
};

struct RowMeta {
    int64_t lo;      // band start (ref offset) of the stored bp row
    size_t off;      // offset into the bp arena
    int64_t len;     // stored width
};

struct Scratch {
    std::vector<int32_t> pm, pi, pd;   // previous row M/I/D bands
    std::vector<int32_t> cm, ci, cd;   // current row
    std::vector<uint8_t> bp;           // current row bp bytes (band-local)
    std::vector<uint8_t> rc;           // current row's ref chars
    std::vector<uint8_t> arena;        // bp history arena
    std::vector<RowMeta> rows;
    // per-call DP stats (band profiling, gapped_last_stats)
    int64_t cells = 0, nrows = 0, max_band = 0;
};

thread_local Scratch g_scr;

// ---------------------------------------------------------------------------
// Fast path: int32 SoA bands, vectorizable M/I pass, serial D/prune pass.
// ---------------------------------------------------------------------------

ExtResult extend_dir_fast(const Dp& dp, int64_t r0, int64_t q0, int dir) {
    const int64_t max_r = std::max<int64_t>(
        0, (dir > 0) ? dp.ref_len - r0 : r0);
    const int64_t max_q = std::max<int64_t>(
        0, (dir > 0) ? dp.query_len - q0 : q0);
    // ref char at band offset j >= 1 / query char at row i >= 1; offsets
    // <= max_r / max_q are always in bounds (see the max_* definitions)
    const uint8_t* rbase = dp.ref + ((dir > 0) ? r0 - 1 : r0);
    const uint8_t* qbase = dp.query + ((dir > 0) ? q0 - 1 : q0);
    const int64_t rstep = dir;
    auto rch = [&](int64_t j) -> int { return rbase[j * rstep]; };
    auto qch = [&](int64_t i) -> int { return qbase[i * rstep]; };

    const int32_t GO = (int32_t)dp.gap_open, GE = (int32_t)dp.gap_extend;
    const int32_t GOE = GO + GE;
    const int32_t ydrop = (int32_t)dp.ydrop;
    int32_t sub32[64];
    for (int k = 0; k < 64; k++) sub32[k] = (int32_t)dp.sub[k];

    int32_t best = 0;
    int64_t best_i = 0, best_j = 0;

    Scratch& S = g_scr;
    S.arena.clear();
    S.rows.clear();
    S.cells = 0;
    S.nrows = 0;
    S.max_band = 0;

    auto store_row = [&](int64_t lo, const uint8_t* src, int64_t len) {
        size_t off = S.arena.size();
        S.arena.insert(S.arena.end(), src, src + len);
        S.rows.push_back(RowMeta{lo, off, len});
    };

    int64_t prev_lo = 0, prev_w = 0;  // prev row = pm/pi/pd[0..prev_w-1]

    // ---- row 0: pure D chain along the reference
    {
        S.pm.clear(); S.pi.clear(); S.pd.clear();
        std::vector<uint8_t> bp0;
        S.pm.push_back(0); S.pi.push_back(NEG32); S.pd.push_back(NEG32);
        bp0.push_back(0);
        for (int64_t j = 1; j <= max_r; j++) {
            if (rch(j) == 6) break;
            int32_t lm = S.pm.back(), ld = S.pd.back();
            int32_t open_s = lm - GOE;
            int32_t ext_s = ld - GE;
            int32_t d = std::max(open_s, ext_s);
            if (d < best - ydrop || d <= NEG32 / 2) break;
            S.pm.push_back(NEG32); S.pi.push_back(NEG32); S.pd.push_back(d);
            bp0.push_back(ext_s > open_s ? BP_D_FROM_D : 0);
        }
        prev_lo = 0;
        prev_w = (int64_t)S.pm.size();
        store_row(0, bp0.data(), (int64_t)bp0.size());
        S.cells += prev_w;
        S.nrows += 1;
        S.max_band = std::max(S.max_band, prev_w);
    }

    for (int64_t i = 1; i <= max_q; i++) {
        if (qch(i) == 6) break;
        const int qc = qch(i);
        const int64_t phi = prev_lo + prev_w - 1;
        const int64_t nlo = prev_lo;
        const int64_t nhi = std::min(phi + 1, max_r);
        if (nlo > nhi) break;
        const int64_t width = nhi - nlo + 1;

        if ((int64_t)S.cm.size() < width) {
            S.cm.resize(width); S.ci.resize(width); S.cd.resize(width);
            S.bp.resize(width); S.rc.resize(width);
        }

        int32_t* __restrict pm = S.pm.data();
        int32_t* __restrict pi = S.pi.data();
        int32_t* __restrict pd = S.pd.data();
        int32_t* __restrict cm = S.cm.data();
        int32_t* __restrict ci = S.ci.data();
        int32_t* __restrict cd = S.cd.data();
        uint8_t* __restrict bp = S.bp.data();
        uint8_t* __restrict rc = S.rc.data();

        // ref chars of this row's band (j = nlo+k >= 1 is in-bounds by the
        // max_r cap; j = 0 — only possible at k = 0 when nlo == 0 — has no
        // ref char and rc[0] is never read by the k >= 1 loops below, but
        // gets the wall value rather than an out-of-bounds byte).
        // Contiguous ascending for dir>0, descending for dir<0.
        {
            const int64_t kf = (nlo == 0) ? 1 : 0;
            if (nlo == 0) rc[0] = 6;
            if (dir > 0) {
                std::memcpy(rc + kf, rbase + nlo + kf, width - kf);
            } else {
                const uint8_t* s = rbase - nlo;
                for (int64_t k = kf; k < width; k++) rc[k] = s[-k];
            }
        }
        // this row's substitution scores by ref char (query char fixed)
        int32_t subq[8];
        for (int c = 0; c < 8; c++) subq[c] = sub32[c * 8 + qc];

        // --- vector pass: M (diagonal) and I (query-gap) states + their
        // bp flags; both read only the previous row. cur index k is ref
        // offset j = nlo + k; the prev row shares lo, so prev index is k.
        {
            const int64_t kiw = std::min(width, prev_w);      // I valid
            const int64_t kmn = std::min(width, prev_w + 1);  // M valid end
            cm[0] = NEG32;  // k=0 has no diagonal (j-1 < prev_lo)
            for (int64_t k = 0; k < kiw; k++) {
                int32_t open_s = pm[k] - GOE;
                int32_t ext_s = pi[k] - GE;
                int32_t v = std::max(open_s, ext_s);
                ci[k] = (v > NEG32 / 2) ? v : NEG32;
                bp[k] = (v > NEG32 / 2 && ext_s > open_s) ? BP_I_FROM_I : 0;
            }
            for (int64_t k = kiw; k < width; k++) { ci[k] = NEG32; bp[k] = 0; }
            // branchless M: sc[] holds this row's substitution score per
            // band cell (wall cells poisoned so the NEG32 select fires),
            // and the bp flags become mask arithmetic — all SIMD-able.
            int32_t* __restrict scr = cd;  // reuse cd as scratch this pass
            for (int64_t k = 1; k < kmn; k++)
                scr[k] = subq[rc[k] & 7];
            for (int64_t k = 1; k < kmn; k++) {
                int32_t dm = pm[k - 1], di = pi[k - 1], dd = pd[k - 1];
                int32_t b = std::max(dm, std::max(di, dd));
                bool ok = (rc[k] != 6) & (b > NEG32 / 2);
                cm[k] = ok ? b + scr[k] : NEG32;
                uint8_t fI = (uint8_t)((di >= dm) & (di >= dd));
                uint8_t fD = (uint8_t)(~fI & (dd >= dm) & (dd > di) & 1);
                uint8_t fl = (uint8_t)((fI * BP_M_FROM_I) |
                                       (fD * BP_M_FROM_D));
                bp[k] |= ok ? fl : 0;
            }
            for (int64_t k = kmn; k < width; k++) cm[k] = NEG32;
        }

        // --- serial pass: D chain + ydrop prune. D sources the previous
        // cell AFTER its prune-zap, and `best` (the prune threshold) rises
        // left to right within the row — both are semantic.
        int64_t first_keep = -1, last_keep = -1;
        {
            const int32_t cut0 = best - ydrop;
            int32_t cut = cut0;
            int32_t lm = cm[0], ld;
            // k = 0: no D (j == nlo or the wall check handles it below)
            {
                int32_t sc = std::max(cm[0], ci[0]);
                cd[0] = NEG32;
                if (sc < cut || sc <= NEG32 / 2) {
                    cm[0] = NEG32; ci[0] = NEG32; bp[0] = 0; lm = NEG32;
                } else {
                    first_keep = nlo; last_keep = nlo;
                    if (cm[0] > best) {
                        best = cm[0]; best_i = i; best_j = nlo;
                        cut = best - ydrop;
                    }
                }
            }
            ld = NEG32;
            for (int64_t k = 1; k < width; k++) {
                int32_t d = NEG32;
                uint8_t b = bp[k];
                if (rc[k] != 6) {
                    int32_t open_s = lm - GOE;
                    int32_t ext_s = ld - GE;
                    int32_t v = std::max(open_s, ext_s);
                    if (v > NEG32 / 2) {
                        d = v;
                        if (ext_s > open_s) b |= BP_D_FROM_D;
                    }
                }
                int32_t m = cm[k];
                int32_t sc = std::max(m, std::max(ci[k], d));
                if (sc < cut || sc <= NEG32 / 2) {
                    cm[k] = NEG32; ci[k] = NEG32; d = NEG32; b = 0;
                    m = NEG32;
                } else {
                    if (first_keep < 0) first_keep = nlo + k;
                    last_keep = nlo + k;
                    if (m > best) {
                        best = m; best_i = i; best_j = nlo + k;
                        cut = best - ydrop;
                    }
                }
                cd[k] = d;
                bp[k] = b;
                lm = m;
                ld = d;
            }
        }
        if (first_keep < 0) break;

        S.cells += width;
        S.nrows += 1;
        S.max_band = std::max(S.max_band, last_keep - first_keep + 1);

        store_row(first_keep, bp + (first_keep - nlo),
                  last_keep - first_keep + 1);
        // roll: prev <- cur trimmed to [first_keep, last_keep]
        const int64_t tw = last_keep - first_keep + 1;
        const int64_t toff = first_keep - nlo;
        if ((int64_t)S.pm.size() < tw) {
            S.pm.resize(tw); S.pi.resize(tw); S.pd.resize(tw);
        }
        std::memmove(S.pm.data(), cm + toff, tw * sizeof(int32_t));
        std::memmove(S.pi.data(), ci + toff, tw * sizeof(int32_t));
        std::memmove(S.pd.data(), cd + toff, tw * sizeof(int32_t));
        prev_lo = first_keep;
        prev_w = tw;
    }

    ExtResult out;
    out.score = best;
    out.r_ext = best_j;
    out.q_ext = best_i;
    int64_t i = best_i, j = best_j;
    int state = 0;  // 0=M 1=I 2=D
    std::vector<uint8_t> ops;
    while (i > 0 || j > 0) {
        const RowMeta& row = S.rows[i];
        uint8_t b = S.arena[row.off + (j - row.lo)];
        if (state == 0 && i > 0 && j > 0) {
            ops.push_back('M');
            state = (b & BP_M_FROM_I) ? 1 : (b & BP_M_FROM_D) ? 2 : 0;
            i--; j--;
        } else if (state == 1 || (state == 0 && j == 0)) {
            ops.push_back('I');
            state = (b & BP_I_FROM_I) ? 1 : 0;
            i--;
        } else {
            ops.push_back('D');
            state = (b & BP_D_FROM_D) ? 2 : 0;
            j--;
        }
    }
    std::reverse(ops.begin(), ops.end());
    out.ops = std::move(ops);
    return out;
}

// ---------------------------------------------------------------------------
// Wide fallback (the original row-of-structs int64 implementation) for
// extensions long enough that int32 scores could overflow. Identical
// recurrence; kept verbatim.
// ---------------------------------------------------------------------------

struct Cell {
    int64_t m, ins, del;
};

struct BpRow {
    int64_t lo = 0;
    std::vector<uint8_t> bp;
};

ExtResult extend_dir_wide(const Dp& dp, int64_t r0, int64_t q0, int dir) {
    auto rch = [&](int64_t j) -> int {  // ref char at offset j >= 1
        int64_t p = (dir > 0) ? r0 + j - 1 : r0 - j;
        if (p < 0 || p >= dp.ref_len) return 6;
        return dp.ref[p];
    };
    auto qch = [&](int64_t i) -> int {
        int64_t p = (dir > 0) ? q0 + i - 1 : q0 - i;
        if (p < 0 || p >= dp.query_len) return 6;
        return dp.query[p];
    };
    int64_t max_r = (dir > 0) ? dp.ref_len - r0 : r0;
    int64_t max_q = (dir > 0) ? dp.query_len - q0 : q0;
    if (max_r < 0) max_r = 0;
    if (max_q < 0) max_q = 0;

    int64_t best = 0, best_i = 0, best_j = 0;

    std::vector<BpRow> history;
    std::vector<Cell> prev;       // cells of the previous row (band-local)
    int64_t prev_lo = 0;

    // ---- row 0: pure D chain along the reference
    {
        BpRow row;
        row.lo = 0;
        prev.clear();
        prev.push_back(Cell{0, NEG_INF, NEG_INF});
        row.bp.push_back(0);
        for (int64_t j = 1; j <= max_r; j++) {
            if (rch(j) == 6) break;
            const Cell& l = prev.back();
            int64_t open_s = l.m - dp.gap_open - dp.gap_extend;
            int64_t ext_s = l.del - dp.gap_extend;
            int64_t d = std::max(open_s, ext_s);
            if (d < best - dp.ydrop || d <= NEG_INF / 2) break;
            prev.push_back(Cell{NEG_INF, NEG_INF, d});
            row.bp.push_back(ext_s > open_s ? BP_D_FROM_D : 0);
        }
        prev_lo = 0;
        history.push_back(std::move(row));
    }

    for (int64_t i = 1; i <= max_q; i++) {
        if (qch(i) == 6) break;
        int qc = qch(i);
        int64_t phi = prev_lo + (int64_t)prev.size() - 1;
        int64_t nlo = prev_lo;
        int64_t nhi = std::min(phi + 1, max_r);
        if (nlo > nhi) break;

        std::vector<Cell> cur;
        std::vector<uint8_t> bps;
        cur.reserve(nhi - nlo + 2);
        int64_t first_keep = -1, last_keep = -1;

        for (int64_t j = nlo; j <= nhi; j++) {
            Cell c{NEG_INF, NEG_INF, NEG_INF};
            uint8_t bp = 0;
            int rc = (j >= 1) ? rch(j) : 6;

            // M from (i-1, j-1)
            if (j >= 1 && rc != 6 && j - 1 >= prev_lo && j - 1 <= phi) {
                const Cell& d = prev[j - 1 - prev_lo];
                int64_t b = std::max({d.m, d.ins, d.del});
                if (b > NEG_INF / 2) {
                    c.m = b + dp.sub[rc * 8 + qc];
                    if (d.ins >= d.m && d.ins >= d.del) bp |= BP_M_FROM_I;
                    else if (d.del >= d.m && d.del > d.ins) bp |= BP_M_FROM_D;
                }
            }
            // I from (i-1, j)
            if (j >= prev_lo && j <= phi) {
                const Cell& u = prev[j - prev_lo];
                int64_t open_s = u.m - dp.gap_open - dp.gap_extend;
                int64_t ext_s = u.ins - dp.gap_extend;
                int64_t v = std::max(open_s, ext_s);
                if (v > NEG_INF / 2) {
                    c.ins = v;
                    if (ext_s > open_s) bp |= BP_I_FROM_I;
                }
            }
            // D from (i, j-1) within this row
            if (j > nlo && rc != 6 && !cur.empty()) {
                const Cell& l = cur.back();
                int64_t open_s = l.m - dp.gap_open - dp.gap_extend;
                int64_t ext_s = l.del - dp.gap_extend;
                int64_t v = std::max(open_s, ext_s);
                if (v > NEG_INF / 2) {
                    c.del = v;
                    if (ext_s > open_s) bp |= BP_D_FROM_D;
                }
            }

            int64_t sc = std::max({c.m, c.ins, c.del});
            if (sc < best - dp.ydrop || sc <= NEG_INF / 2) {
                // prune: zap so nothing can source from this cell
                c = Cell{NEG_INF, NEG_INF, NEG_INF};
                bp = 0;
            } else {
                if (first_keep < 0) first_keep = j;
                last_keep = j;
                if (c.m > best) { best = c.m; best_i = i; best_j = j; }
            }
            cur.push_back(c);
            bps.push_back(bp);
        }
        if (first_keep < 0) break;

        BpRow row;
        row.lo = first_keep;
        row.bp.assign(bps.begin() + (first_keep - nlo),
                      bps.begin() + (last_keep - nlo) + 1);
        history.push_back(std::move(row));
        prev.assign(cur.begin() + (first_keep - nlo),
                    cur.begin() + (last_keep - nlo) + 1);
        prev_lo = first_keep;
    }

    ExtResult out;
    out.score = best;
    out.r_ext = best_j;
    out.q_ext = best_i;
    int64_t i = best_i, j = best_j;
    int state = 0;  // 0=M 1=I 2=D
    std::vector<uint8_t> ops;
    while (i > 0 || j > 0) {
        const BpRow& row = history[i];
        uint8_t bp = row.bp[j - row.lo];
        if (state == 0 && i > 0 && j > 0) {
            ops.push_back('M');
            state = (bp & BP_M_FROM_I) ? 1 : (bp & BP_M_FROM_D) ? 2 : 0;
            i--; j--;
        } else if (state == 1 || (state == 0 && j == 0)) {
            ops.push_back('I');
            state = (bp & BP_I_FROM_I) ? 1 : 0;
            i--;
        } else {
            ops.push_back('D');
            state = (bp & BP_D_FROM_D) ? 2 : 0;
            j--;
        }
    }
    std::reverse(ops.begin(), ops.end());
    out.ops = std::move(ops);
    return out;
}

ExtResult extend_dir(const Dp& dp, int64_t r0, int64_t q0, int dir) {
    int64_t max_r = (dir > 0) ? dp.ref_len - r0 : r0;
    int64_t max_q = (dir > 0) ? dp.query_len - q0 : q0;
    if (std::min(max_r, max_q) <= MAX_I32_EXT)
        return extend_dir_fast(dp, r0, q0, dir);
    return extend_dir_wide(dp, r0, q0, dir);
}

thread_local int64_t g_stats[6];  // cells, rows, max_band x {right, left}

}  // namespace

extern "C" {

// Gapped extension from one anchor. ops_out receives the edit script
// ('M','I','D'); returns its length or -1 if it exceeds ops_cap.
// meta_out = {score, r_start, q_start, r_end, q_end} (half-open, 0-based).
int64_t gapped_extend(
    const uint8_t* ref, int64_t ref_len, const uint8_t* query,
    int64_t query_len, const int64_t* sub8x8, int64_t gap_open,
    int64_t gap_extend, int64_t ydrop, int64_t anchor_r, int64_t anchor_q,
    uint8_t* ops_out, int64_t ops_cap, int64_t* meta_out) {
    Dp dp{ref, ref_len, query, query_len, sub8x8, gap_open, gap_extend,
          ydrop};
    ExtResult right = extend_dir(dp, anchor_r, anchor_q, +1);
    g_stats[0] = g_scr.cells; g_stats[1] = g_scr.nrows;
    g_stats[2] = g_scr.max_band;
    ExtResult left = extend_dir(dp, anchor_r, anchor_q, -1);
    g_stats[3] = g_scr.cells; g_stats[4] = g_scr.nrows;
    g_stats[5] = g_scr.max_band;

    int64_t total = (int64_t)(left.ops.size() + right.ops.size());
    if (total > ops_cap) return -1;
    int64_t k = 0;
    for (auto it = left.ops.rbegin(); it != left.ops.rend(); ++it)
        ops_out[k++] = *it;
    for (uint8_t op : right.ops) ops_out[k++] = op;

    meta_out[0] = left.score + right.score;
    meta_out[1] = anchor_r - left.r_ext;
    meta_out[2] = anchor_q - left.q_ext;
    meta_out[3] = anchor_r + right.r_ext;
    meta_out[4] = anchor_q + right.q_ext;
    return total;
}

// DP band statistics of this thread's most recent gapped_extend call
// (fast path only): {cells, rows, max_band} for the right then left
// extensions. For band profiling (VERDICT r3 #7).
void gapped_last_stats(int64_t* out6) {
    for (int k = 0; k < 6; k++) out6[k] = g_stats[k];
}

}  // extern "C"
