// Host-native chunk seeding + hit expansion.
//
// TPU-native equivalent of the reference's CPU seeder stage
// (reference/src/seeder.cpp:47-121 + GetKmerIndexAtPos,
// common/ntcoding.cpp:43-61) combined with the GPU hit enumeration
// (find_num_hits/find_hits, reference/src/seed_filter.cu:157-230).
//
// Rationale: XLA's TPU gather/searchsorted lowerings are latency-bound
// (measured ~60-100 ms for the per-chunk lookup volume), while the same
// random lookups run in ~10 ms multithreaded on host with software
// prefetch. The reference also seeds on CPU. The TPU keeps what it is good
// at: the dense x-drop extension scan.
//
// Semantics are kept bit-identical to ops/seeding.py + ops/hits.py:
//   - seed slot order: position-major, base kmer then transition variants
//     t = 0..k-1 (XOR TRANSITION_MASK << 2t)
//   - a position is valid only if ALL seed_size window bytes are codes 0-3
//     and the window lies inside the query array
//   - per-slot hit count  = index_table[kmer] - index_table[kmer-1]
//     (0 for kmer == 0 lower bound, 0 for invalid slots)
//   - emitted hit order within a slot follows pos_table bucket order;
//     ref_loc/query_loc carry the +seed_size offset of find_hits
//     (seed_filter.cu:204,220)
//   - iteration-batch boundaries replicate the lower_bound chain of
//     SeedAndFilter (seed_filter.cu:718-745) over the inclusive seed-count
//     cumsum, matching pipeline/device.py::_plan_limits exactly.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int64_t TRANSITION_MASK = 2;

struct CountArgs {
    const uint8_t* q;
    int64_t qlen;
    int64_t chunk_start;
    int64_t chunk_len;
    const int32_t* index_table;
    const int32_t* shape_pos;
    int64_t k;
    int64_t seed_size;
    int64_t nvar;
    int32_t* cnt;
    int32_t* bstart;
};

// Per-position kmer validity + base kmer value.
static inline bool base_kmer(const CountArgs& a, int64_t j, uint32_t* kmer) {
    const int64_t p = a.chunk_start + j;
    if (p + a.seed_size > a.qlen) return false;
    const uint8_t* w = a.q + p;
    for (int64_t i = 0; i < a.seed_size; i++) {
        if (w[i] >= 4) return false;
    }
    uint32_t km = 0;
    for (int64_t i = 0; i < a.k; i++) {
        km = (km << 2) | (uint32_t)(w[a.shape_pos[i]] & 3);
    }
    *kmer = km;
    return true;
}

static void count_range(const CountArgs& a, int64_t j0, int64_t j1,
                        int64_t* hits_out, int64_t* seeds_out) {
    const int32_t* it = a.index_table;
    const int64_t nvar = a.nvar;
    int64_t hits = 0, seeds = 0;

    // software pipeline: compute + prefetch kmers D positions ahead
    constexpr int64_t D = 8;
    uint32_t kmers[D];
    bool valid[D];

    auto stage = [&](int64_t j, int64_t slot) {
        valid[slot] = base_kmer(a, j, &kmers[slot]);
        if (valid[slot]) {
            uint32_t km = kmers[slot];
            __builtin_prefetch(&it[km], 0, 1);
            if (nvar > 1) {
                for (int64_t t = 0; t < a.k; t++) {
                    __builtin_prefetch(&it[km ^ (TRANSITION_MASK << (2 * t))],
                                       0, 1);
                }
            }
        }
    };

    auto drain = [&](int64_t j, int64_t slot) {
        int32_t* cn = a.cnt + j * nvar;
        int32_t* bs = a.bstart + j * nvar;
        if (!valid[slot]) {
            for (int64_t v = 0; v < nvar; v++) { cn[v] = 0; bs[v] = 0; }
            return;
        }
        seeds += nvar;
        const uint32_t km = kmers[slot];
        for (int64_t v = 0; v < nvar; v++) {
            const uint32_t kv =
                v == 0 ? km
                       : km ^ (uint32_t)(TRANSITION_MASK << (2 * (v - 1)));
            const int32_t end = it[kv];
            const int32_t start = kv > 0 ? it[kv - 1] : 0;
            cn[v] = end - start;
            bs[v] = start;
            hits += end - start;
        }
    };

    const int64_t n = j1 - j0;
    const int64_t head = n < D ? n : D;
    for (int64_t s = 0; s < head; s++) stage(j0 + s, s);
    for (int64_t j = j0; j < j1; j++) {
        const int64_t slot = (j - j0) % D;
        drain(j, slot);
        const int64_t nxt = j + D;
        if (nxt < j1) stage(nxt, slot);
    }
    *hits_out = hits;
    *seeds_out = seeds;
}

struct EmitArgs {
    const int32_t* pos_table;
    const int32_t* cnt;
    const int32_t* bstart;
    int64_t S;
    int64_t chunk_start;
    int64_t seed_size;
    int64_t nvar;
    int32_t* ref_loc;
    int32_t* query_loc;
};

static void emit_range(const EmitArgs& a, int64_t s0, int64_t s1,
                       int64_t off) {
    int32_t* rl = a.ref_loc + off;
    int32_t* ql = a.query_loc + off;
    const int32_t ss = (int32_t)a.seed_size;
    for (int64_t s = s0; s < s1; s++) {
        const int32_t c = a.cnt[s];
        if (c == 0) continue;
        const int32_t b = a.bstart[s];
        const int32_t qp = (int32_t)(a.chunk_start + s / a.nvar) + ss;
        for (int32_t i = 0; i < c; i++) {
            *rl++ = a.pos_table[b + i] + ss;
            *ql++ = qp;
        }
    }
}

}  // namespace

extern "C" {

// Pass 1: per-slot hit counts + bucket starts. Fills cnt[S], bstart[S]
// (S = chunk_len * nvar), returns total hits; *num_seeds_out = valid slots.
int64_t seed_chunk_count(const uint8_t* q, int64_t qlen, int64_t chunk_start,
                         int64_t chunk_len, const int32_t* index_table,
                         const int32_t* shape_pos, int64_t kmer_size,
                         int64_t seed_size, int64_t transition,
                         int64_t nthreads, int32_t* cnt, int32_t* bstart,
                         int64_t* num_seeds_out) {
    CountArgs a{q,  qlen,      chunk_start, chunk_len,
                index_table,   shape_pos,   kmer_size,
                seed_size,     transition ? 1 + kmer_size : 1,
                cnt,           bstart};
    const int64_t T =
        nthreads > 0 ? (nthreads < chunk_len ? nthreads : 1) : 1;
    std::vector<int64_t> hits(T, 0), seeds(T, 0);
    if (T == 1) {
        count_range(a, 0, chunk_len, &hits[0], &seeds[0]);
    } else {
        std::vector<std::thread> ths;
        const int64_t per = (chunk_len + T - 1) / T;
        for (int64_t t = 0; t < T; t++) {
            const int64_t j0 = t * per;
            const int64_t j1 = std::min(chunk_len, j0 + per);
            if (j0 >= j1) break;
            ths.emplace_back([&, t, j0, j1] {
                count_range(a, j0, j1, &hits[t], &seeds[t]);
            });
        }
        for (auto& th : ths) th.join();
    }
    int64_t total_hits = 0, total_seeds = 0;
    for (int64_t t = 0; t < T; t++) {
        total_hits += hits[t];
        total_seeds += seeds[t];
    }
    *num_seeds_out = total_seeds;
    return total_hits;
}

// Batch planning: the reference's lower_bound chain over the inclusive
// cumsum of cnt[0..S). Writes up to cap (limit_pos, hit_bound) pairs,
// returns the batch count (pipeline/device.py semantics, incl. the
// trailing-duplicate drop).
int64_t seed_plan_batches(const int32_t* cnt, int64_t S, int64_t num_hits,
                          int64_t max_hits, int64_t* limit_pos,
                          int64_t* hit_bound, int64_t cap) {
    const int64_t num_iter =
        num_hits < max_hits ? 2 : num_hits / max_hits + 2;
    int64_t nb = 0;
    int64_t limit = num_hits < max_hits ? num_hits : max_hits;
    int64_t idx = 0;      // next slot to consume in the forward walk
    int64_t cum = 0;      // inclusive cumsum up to slot idx-1
    for (int64_t it = 0; it < num_iter - 1; it++) {
        // pos = searchsorted(cum_array, limit, side=left) - 1
        //     = last index with cum_array[index] < limit
        while (idx < S && cum + cnt[idx] < limit) cum += cnt[idx++];
        const int64_t pos = idx - 1;
        const int64_t val = pos >= 0 ? cum : 0;
        if (nb < cap) {
            limit_pos[nb] = pos;
            hit_bound[nb] = val;
        }
        nb++;
        limit = val + max_hits < num_hits ? val + max_hits : num_hits;
    }
    if (nb < cap) {
        limit_pos[nb] = S - 1;
        hit_bound[nb] = num_hits;
    }
    nb++;
    if (nb >= 2 && nb <= cap && limit_pos[nb - 1] == limit_pos[nb - 2]) {
        nb--;
    }
    return nb;
}

// Pass 2: emit all hits in slot order into ref_loc/query_loc (each sized
// num_hits from pass 1).
void seed_chunk_emit(const int32_t* pos_table, const int32_t* cnt,
                     const int32_t* bstart, int64_t S, int64_t chunk_start,
                     int64_t seed_size, int64_t nvar, int64_t nthreads,
                     int32_t* ref_loc, int32_t* query_loc) {
    EmitArgs a{pos_table, cnt,  bstart, S,        chunk_start,
               seed_size, nvar, ref_loc, query_loc};
    const int64_t T = nthreads > 0 ? nthreads : 1;
    if (T == 1 || S < (1 << 16)) {
        emit_range(a, 0, S, 0);
        return;
    }
    // per-thread contiguous slot ranges; offsets via per-range count sums
    const int64_t per = (S + T - 1) / T;
    std::vector<int64_t> offs(T + 1, 0);
    std::vector<std::thread> ths;
    std::vector<int64_t> sums(T, 0);
    for (int64_t t = 0; t < T; t++) {
        const int64_t s0 = t * per, s1 = std::min(S, s0 + per);
        ths.emplace_back([&, t, s0, s1] {
            int64_t sum = 0;
            for (int64_t s = s0; s < s1; s++) sum += a.cnt[s];
            sums[t] = sum;
        });
    }
    for (auto& th : ths) th.join();
    ths.clear();
    for (int64_t t = 0; t < T; t++) offs[t + 1] = offs[t] + sums[t];
    for (int64_t t = 0; t < T; t++) {
        const int64_t s0 = t * per, s1 = std::min(S, s0 + per);
        if (s0 >= s1) break;
        ths.emplace_back(
            [&, t, s0, s1] { emit_range(a, s0, s1, offs[t]); });
    }
    for (auto& th : ths) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Seed position table build (TPU-native equivalent of GenerateSeedPosTable,
// reference/common/seed_pos_table.cu:49-109). Same output contract as
// index/seed_table.py::build_seed_table (deterministic ascending-position
// buckets): index_table[4^k] inclusive cumulative counts, pos_table bucket-
// major. The numpy build pays tens of seconds in allocator page faults on
// lazily-backed VMs; this one runs in-place in caller-owned buffers.

extern "C" {

// codes[ref_len] -> index_table[4^kmer] (must be ZEROED on entry),
// pos_table[num_steps cap], kmer_scratch[num_steps cap]. Returns the number
// of positions written to pos_table (invalid windows skipped).
int64_t build_seed_table_native(const uint8_t* codes, int64_t ref_len,
                                int64_t step, const int32_t* shape_pos,
                                int64_t kmer_size, int64_t seed_size,
                                int64_t nthreads, int32_t* index_table,
                                int32_t* pos_table, int32_t* kmer_scratch) {
    const int64_t offset = (seed_size + 1) % step;
    const int64_t start_offset = step - offset;
    const int64_t num_steps = (ref_len - seed_size + offset) / step;
    if (num_steps <= 0) return 0;
    const int64_t tablesize = int64_t(1) << (2 * kmer_size);

    // phase 1 (threaded): validity + kmer per step position; histogram via
    // atomic adds (buckets are numerous, contention negligible)
    const int64_t T = nthreads > 1 && num_steps > (1 << 16) ? nthreads : 1;
    std::vector<std::thread> ths;
    const int64_t per = (num_steps + T - 1) / T;
    auto phase1 = [&](int64_t i0, int64_t i1) {
        for (int64_t i = i0; i < i1; i++) {
            const int64_t p = start_offset + i * step;
            const uint8_t* w = codes + p;
            bool ok = true;
            for (int64_t j = 0; j < seed_size; j++) {
                if (w[j] >= 4) { ok = false; break; }
            }
            if (!ok) { kmer_scratch[i] = -1; continue; }
            uint32_t km = 0;
            for (int64_t j = 0; j < kmer_size; j++) {
                km = (km << 2) | (uint32_t)(w[shape_pos[j]] & 3);
            }
            kmer_scratch[i] = (int32_t)km;
            __atomic_fetch_add(&index_table[km], 1, __ATOMIC_RELAXED);
        }
    };
    if (T == 1) {
        phase1(0, num_steps);
    } else {
        for (int64_t t = 0; t < T; t++) {
            const int64_t i0 = t * per, i1 = std::min(num_steps, i0 + per);
            if (i0 >= i1) break;
            ths.emplace_back(phase1, i0, i1);
        }
        for (auto& th : ths) th.join();
        ths.clear();
    }

    // phase 2: exclusive prefix in place (cursors for the scatter)
    int32_t run = 0;
    for (int64_t k = 0; k < tablesize; k++) {
        const int32_t c = index_table[k];
        index_table[k] = run;
        run += c;
    }

    // phase 3: stable scatter in ascending position order; afterwards
    // index_table[k] = exclusive[k] + count[k] = inclusive prefix
    int64_t n = 0;
    for (int64_t i = 0; i < num_steps; i++) {
        const int32_t km = kmer_scratch[i];
        if (km < 0) continue;
        pos_table[index_table[km]++] = (int32_t)(start_offset + i * step);
        n++;
    }
    return n;
}

}  // extern "C"
