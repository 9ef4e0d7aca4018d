// Host-side exact k-mer row probe for the alt-stage-2 whitelist scan
// (ops/exact_lookup.py). Pointer-chase hash lookups are a memory-LATENCY
// workload: the TPU binary-search/gather probes cost ~1us/query (HBM gather
// latency serializes, ROADMAP probe shootout), while an L2-resident
// open-addressing table on the host answers in ~100ns. Like BGZF decode,
// this belongs on the host; the device keeps the FLOP-heavy stages.
//
// Per row (a segment), every k-length window packs to a uint32 (2 bits per
// base, first base = most significant — matching core.packing
// pack_kmers_from_codes) and probes the prebuilt table (hash_table.cpp
// layout: power-of-two size, Knuth multiplicative hash, linear probing,
// empty iff tvals[slot] == INT32_MIN). Windows containing any non-ACGT byte
// match nothing. Outputs per row: hit count and the value of the single hit
// (meaningful when count == 1) — the reference's ambiguity rule inputs
// (scTagger.py:822-826).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

void sctag_probe_rows(const char* seq_buf, const int64_t* offs,
                      int64_t n_rows, const uint32_t* tkeys,
                      const int32_t* tvals, int64_t tsize, int k,
                      int nthreads, int64_t* out_counts,
                      int64_t* out_single) {
    const uint32_t mask = static_cast<uint32_t>(tsize - 1);
    int shift = 32;
    for (int64_t s = tsize; s > 1; s >>= 1) shift--;

    // base codes: A/C/G/T -> 0..3, everything else 0xff (window invalid) —
    // STRICT_TABLE semantics (core/packing.py)
    uint8_t code[256];
    std::memset(code, 0xff, sizeof(code));
    code[(int)'A'] = 0;
    code[(int)'C'] = 1;
    code[(int)'G'] = 2;
    code[(int)'T'] = 3;

    const uint32_t kmask =
        k >= 16 ? 0xffffffffu : ((1u << (2 * k)) - 1);

    auto worker = [&](int64_t r0, int64_t r1) {
        for (int64_t r = r0; r < r1; r++) {
            const uint8_t* s = (const uint8_t*)seq_buf + offs[r];
            int64_t len = offs[r + 1] - offs[r];
            int64_t cnt = 0;
            int64_t single = 0;
            uint32_t key = 0;
            int run = 0;  // consecutive valid bases ending here
            for (int64_t j = 0; j < len; j++) {
                uint8_t c = code[s[j]];
                if (c == 0xff) {
                    run = 0;
                    key = 0;
                    continue;
                }
                key = ((key << 2) | c) & kmask;
                if (++run < k) continue;
                uint32_t h = (key * 2654435761u) >> shift;
                for (;;) {
                    uint32_t slot = h & mask;
                    int32_t v = tvals[slot];
                    if (v == INT32_MIN) break;  // empty: miss
                    if (tkeys[slot] == key) {
                        cnt++;
                        single = v;
                        break;
                    }
                    h++;
                }
            }
            out_counts[r] = cnt;
            out_single[r] = cnt == 1 ? single : 0;
        }
    };

    int nw = nthreads < 1 ? 1 : nthreads;
    if (nw == 1 || n_rows < 2048) {
        worker(0, n_rows);
        return;
    }
    std::vector<std::thread> pool;
    for (int w = 1; w < nw; w++)
        pool.emplace_back(worker, n_rows * w / nw, n_rows * (w + 1) / nw);
    worker(0, n_rows / nw);
    for (auto& t : pool) t.join();
}

}  // extern "C"
