// match_trie's output, formatted and written by a pool of threads
// (io/match_writer.py).
//
// Rows as tsv_writer.cpp's sctag_write_match_tsv (reference
// scTagger.py:777-790), for MATCHED reads only, ascending rid:
//   name \t dist \t n_ties \t segment \t bc1,bc2,... \n
//
// The rows are cut into blocks of at least `block_bytes` formatted bytes
// (the last block may be shorter), always at a row boundary. The cut depends
// on the rows alone, never on the thread count, so the file is the same
// bytes on any host. Each worker takes the next block, formats it and, for
// a gz output, deflates it into one complete gzip member (a compressor of
// its own: libdeflate's when the build has it, as tsv_writer.cpp's, else
// zlib's with windowBits 31); the calling thread writes the blocks in order
// as they finish. Every
// gzip reader of a match output (Python's gzip, zlib's gzread in
// tsv_reader.cpp, gz_inflate.cpp, zcat) reads concatenated members as one
// stream, so the decompressed bytes are those of a single-member file.
//
// Every large buffer is calloc'd: first-touch writes to plain malloc pages
// are slow on some kernels, calloc'd pages are not (fastq_reader.cpp's Buf).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <zlib.h>

#if !defined(SCTAG_NO_LIBDEFLATE) && __has_include(<libdeflate.h>)
#include <libdeflate.h>
#define SCTAG_MTW_LIBDEFLATE 1
#endif

namespace {

char* mtw_err(const char* m) {
    char* e = (char*)std::malloc(std::strlen(m) + 1);
    if (e) std::strcpy(e, m);
    return e;
}

int n_digits(int64_t v) {
    uint64_t u = v < 0 ? (uint64_t)(-(v + 1)) + 1 : (uint64_t)v;
    int n = v < 0 ? 2 : 1;
    while (u >= 10) {
        u /= 10;
        n++;
    }
    return n;
}

// decimal int64 -> buffer, returns chars written (no terminator)
int put_i64(int64_t v, char* out) {
    char tmp[24];
    int k = 0;
    uint64_t u = v < 0 ? (uint64_t)(-(v + 1)) + 1 : (uint64_t)v;
    do {
        tmp[k++] = (char)('0' + u % 10);
        u /= 10;
    } while (u);
    int w = 0;
    if (v < 0) out[w++] = '-';
    while (k) out[w++] = tmp[--k];
    return w;
}

struct Rows {
    const char* names;        // row i's name: names[name_offs[i], name_offs[i+1] - 1)
    const int64_t* name_offs;
    const char* seg_buf;
    const int64_t* seg_offs;  // indexed by rid
    const int64_t* rids;
    const int64_t* dists;
    const int64_t* tie_counts;
    const int64_t* tie_slots;  // (m, k): a row's ties when it has at most k
    int64_t k;
    const int64_t* overflow;   // the longer rows' ties, one after another
    const char* bc;            // pattern p prints bc[p * bl, (p + 1) * bl)
    int64_t bl;

    int64_t bytes(int64_t i) const {
        int64_t rid = rids[i];
        int64_t nt = tie_counts[i];
        return (name_offs[i + 1] - name_offs[i] - 1) + n_digits(dists[i]) +
               n_digits(nt) + (seg_offs[rid + 1] - seg_offs[rid]) +
               nt * bl + (nt > 0 ? nt - 1 : 0) + 5;
    }

    // rows [lo, hi) into p, the first overflow row's ties at overflow[ovf];
    // returns the end
    char* format(int64_t lo, int64_t hi, int64_t ovf, char* p) const {
        for (int64_t i = lo; i < hi; i++) {
            int64_t nl = name_offs[i + 1] - name_offs[i] - 1;
            std::memcpy(p, names + name_offs[i], (size_t)nl);
            p += nl;
            *p++ = '\t';
            p += put_i64(dists[i], p);
            *p++ = '\t';
            int64_t nt = tie_counts[i];
            p += put_i64(nt, p);
            *p++ = '\t';
            int64_t rid = rids[i];
            int64_t sl = seg_offs[rid + 1] - seg_offs[rid];
            std::memcpy(p, seg_buf + seg_offs[rid], (size_t)sl);
            p += sl;
            *p++ = '\t';
            const int64_t* ties = tie_slots + i * k;
            if (nt > k) {
                ties = overflow + ovf;
                ovf += nt;
            }
            for (int64_t t = 0; t < nt; t++) {
                if (t) *p++ = ',';
                std::memcpy(p, bc + ties[t] * bl, (size_t)bl);
                p += bl;
            }
            *p++ = '\n';
        }
        return p;
    }
};

// one worker's gzip compressor: each call makes one complete member
struct Deflater {
#ifdef SCTAG_MTW_LIBDEFLATE
    libdeflate_compressor* c = nullptr;
    bool init(int level) {
        return (c = libdeflate_alloc_compressor(level)) != nullptr;
    }
    size_t bound(size_t n) { return libdeflate_gzip_compress_bound(c, n); }
    // the member's size, 0 on failure
    size_t run(const char* in, size_t n, char* out, size_t cap) {
        return libdeflate_gzip_compress(c, in, n, out, cap);
    }
    ~Deflater() {
        if (c) libdeflate_free_compressor(c);
    }
#else
    z_stream zs{};
    bool ready = false;
    bool init(int level) {
        return (ready = deflateInit2(&zs, level, Z_DEFLATED, 31, 8,
                                     Z_DEFAULT_STRATEGY) == Z_OK);
    }
    size_t bound(size_t n) { return deflateBound(&zs, (uLong)n); }
    size_t run(const char* in, size_t n, char* out, size_t cap) {
        if (deflateReset(&zs) != Z_OK) return 0;
        zs.next_in = (Bytef*)in;
        zs.avail_in = (uInt)n;
        zs.next_out = (Bytef*)out;
        zs.avail_out = (uInt)cap;
        if (deflate(&zs, Z_FINISH) != Z_STREAM_END) return 0;
        return cap - zs.avail_out;
    }
    ~Deflater() {
        if (ready) deflateEnd(&zs);
    }
#endif
};

struct Block {
    int64_t lo, hi, ovf, raw;  // rows [lo, hi), overflow start, formatted bytes
    char* out = nullptr;     // what the file gets: a member, or the raw rows
    size_t size = 0;
    bool done = false, failed = false;
};

struct Pool {
    const Rows& rows;
    std::vector<Block>& blocks;
    int gz, level;
    int64_t max_raw;
    std::atomic<int64_t> next{0};
    std::atomic<bool> stop{false};
    std::mutex mu;
    std::condition_variable cv;

    Pool(const Rows& r, std::vector<Block>& b, int g, int l, int64_t mr)
        : rows(r), blocks(b), gz(g), level(l), max_raw(mr) {}

    // one block into its member (gz) or its raw buffer; false on failure
    bool make(Block& k, Deflater& d, char* raw) {
        if (!gz) {
            k.out = (char*)std::calloc((size_t)(k.raw ? k.raw : 1), 1);
            if (!k.out) return false;
            k.size = (size_t)(rows.format(k.lo, k.hi, k.ovf, k.out) - k.out);
            return true;
        }
        size_t usz = (size_t)(rows.format(k.lo, k.hi, k.ovf, raw) - raw);
        size_t bound = d.bound(usz);
        k.out = (char*)std::calloc(bound, 1);
        k.size = k.out ? d.run(raw, usz, k.out, bound) : 0;
        return k.size > 0;
    }

    // take blocks until none is left
    void work() {
        Deflater d;
        char* raw = nullptr;
        bool ready = !gz;
        if (gz) {
            raw = (char*)std::calloc((size_t)(max_raw ? max_raw : 1), 1);
            ready = raw && d.init(level);
        }
        for (;;) {
            int64_t b = next.fetch_add(1);
            if (b >= (int64_t)blocks.size() || stop.load()) break;
            Block& k = blocks[(size_t)b];
            bool ok = ready && make(k, d, raw);
            {
                std::lock_guard<std::mutex> g(mu);
                k.done = true;
                k.failed = !ok;
            }
            cv.notify_all();
        }
        std::free(raw);
    }

    Block& wait(int64_t b) {
        std::unique_lock<std::mutex> g(mu);
        cv.wait(g, [&] { return blocks[(size_t)b].done; });
        return blocks[(size_t)b];
    }
};

}  // namespace

// Write the match rows to `path`: gz = 1 deflates each block into a gzip
// member at `level`, gz = 0 writes the rows as they are. min(blocks, cores)
// workers make the blocks; a single worker is the caller itself. On return
// stats[0] = blocks, stats[1] = threads, stats[2] = formatted bytes.
extern "C" int sctag_write_match_tsv_mt(
    const char* path,
    int gz, int level,
    const char* names, const int64_t* name_offs,  // m+1 starts, '\n' after each
    const char* seg_buf, const int64_t* seg_offs,
    const int64_t* rids, int64_t m,
    const int64_t* dists,
    const int64_t* tie_counts,
    const int64_t* tie_slots, int64_t k,  // (m, k) ties of the rows with <= k
    const int64_t* overflow,  // the ties of each row with more, in row order
    const char* bc_blob, int64_t bl,
    int64_t block_bytes, int cores,
    int64_t* stats,
    char** err) {
    Rows rows{names, name_offs, seg_buf, seg_offs, rids, dists,
              tie_counts, tie_slots, k, overflow, bc_blob, bl};
    std::vector<Block> blocks;
    int64_t total = 0, max_raw = 0;
    {
        Block b{0, 0, 0, 0};
        int64_t ovf = 0;
        for (int64_t i = 0; i < m; i++) {
            b.raw += rows.bytes(i);
            b.hi = i + 1;
            if (tie_counts[i] > k) ovf += tie_counts[i];
            if (b.raw >= block_bytes || i + 1 == m) {
                blocks.push_back(b);
                total += b.raw;
                if (b.raw > max_raw) max_raw = b.raw;
                b = Block{b.hi, b.hi, ovf, 0};
            }
        }
        if (blocks.empty()) blocks.push_back(b);  // no rows: one empty member
    }
    if (max_raw > ((int64_t)1 << 30)) {
        *err = mtw_err("match writer: a block of rows over 1 GiB");
        return 1;
    }
    int64_t nb = (int64_t)blocks.size();
    int threads = (int)(nb < cores ? nb : cores);
    if (threads < 1) threads = 1;
    stats[0] = nb;
    stats[1] = threads;
    stats[2] = total;

    FILE* f = std::fopen(path, "wb");
    if (!f) {
        *err = mtw_err("match writer: cannot open output file");
        return 1;
    }
    Pool pool(rows, blocks, gz, level, max_raw);
    std::vector<std::thread> pool_threads;
    const char* fail = nullptr;
    if (threads == 1) {
        pool.work();  // every block in turn on the caller
    } else {
        try {
            for (int t = 0; t < threads; t++)
                pool_threads.emplace_back([&pool] { pool.work(); });
        } catch (...) {
            pool.stop = true;
            fail = "match writer: cannot start threads";
        }
    }
    for (int64_t b = 0; b < nb && !fail; b++) {
        Block& k = pool.wait(b);
        if (k.failed) {
            fail = "match writer: out of memory or deflate failed";
        } else if (std::fwrite(k.out, 1, k.size, f) != k.size) {
            fail = "match writer: write failed";
        }
        std::free(k.out);
        k.out = nullptr;
        if (fail) pool.stop = true;
    }
    for (auto& t : pool_threads) t.join();
    for (auto& k : blocks) std::free(k.out);
    if (std::fclose(f) != 0 && !fail) fail = "match writer: close failed";
    if (fail) {
        *err = mtw_err(fail);
        return 1;
    }
    return 0;
}
