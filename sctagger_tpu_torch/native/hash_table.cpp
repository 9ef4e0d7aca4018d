// Open-addressing hash-table builder for the exact k-mer lookup
// (ops/exact_lookup.py). The whitelist's packed 16-mers (uint32 keys) insert
// serially here — collision chains are inherently sequential — and the
// device probes the table with a short expected chain (~1-2 HBM gathers at
// load factor <= 0.5) instead of a 23-step binary search over 6M keys.
//
// Layout: power-of-two size S; slot i empty iff tvals[i] == INT32_MIN
// (every uint32 is a valid packed k-mer, so emptiness lives in the value
// array). Hash: Knuth multiplicative, h = (key * 2654435761) >> (32 - b),
// linear probing. Inputs are pre-deduplicated (build_key_table keeps the
// reference's keep-last semantics), so insertion never overwrites.

#include <cstdint>

extern "C" {

const int32_t kHashEmpty = INT32_MIN;

// tkeys/tvals must be size elements; tvals pre-filled with kHashEmpty by the
// caller (calloc'd + fill host-side). size must be a power of two > n.
void sctag_hash_build(const uint32_t* keys, const int32_t* vals, int64_t n,
                      int64_t size, uint32_t* tkeys, int32_t* tvals) {
    const uint32_t mask = static_cast<uint32_t>(size - 1);
    int shift = 32;
    for (int64_t s = size; s > 1; s >>= 1) shift--;
    for (int64_t i = 0; i < n; i++) {
        uint32_t h = (keys[i] * 2654435761u) >> shift;
        while (tvals[h & mask] != kHashEmpty) h++;
        tkeys[h & mask] = keys[i];
        tvals[h & mask] = vals[i];
    }
}

}  // extern "C"
