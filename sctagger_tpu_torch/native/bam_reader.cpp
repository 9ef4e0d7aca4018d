// TPU-native equivalent of the reference's pysam/htslib dependency
// (scTagger.py:433-466): a parallel BGZF + BAM reader that streams a
// coordinate-sorted BAM and extracts CB aux tags with the reference's
// filtering semantics:
//   * keep records mapped to a contig (refID >= 0 — pysam fetch(contig)
//     iterates per-contig, so unmapped-at-end records are never seen);
//   * skip records with flag > 256 (note: flag == 256 is KEPT, matching the
//     reference's `aln.flag > 256` test);
//   * barcode = CB tag value up to the first '-'; records whose prefix is
//     "NA" (or with no CB tag) count toward the total but yield no barcode.
//
// BGZF members are independent deflate streams, so inflation parallelizes
// across host threads (the reference decodes contigs in parallel via htslib
// workers, scTagger.py:443-449): blocks are indexed by a header walk, then
// inflated window-by-window with N threads (bounded memory for arbitrarily
// large BAMs) with per-block CRC32 validation, and records are parsed from
// the contiguous uncompressed windows by one thread.
//
// Multi-host sharding (stage drivers' --n-hosts): sctag_extract_cb_range
// processes only the blocks whose compressed offset falls in
// [comp_start, comp_end), skipping `skip` uncompressed bytes at the start
// (the previous shard's record spill, exchanged through the HostGroup sync
// dir) and reporting its own spill past comp_end. Inflation is fully
// parallel across hosts; only the tiny spill handoff serializes.
//
// Counting preserves first-appearance order, which reproduces the
// reference's Counter insertion order for a sequential scan (its -t 1
// behavior; with >1 thread the reference's equal-count ordering is
// nondeterministic — SURVEY.md §7 hard parts). Sharded scans additionally
// report each barcode's first local record index so hosts can reconstruct
// the exact global first-appearance order (stages/extract_sr_bc.py).
//
// Build: g++ -O2 -shared -fPIC bam_reader.cpp -o libsctag_io.so -lz

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <zlib.h>

// BGZF members are bounded (<=64 KiB) whole-buffer DEFLATE streams — exactly
// libdeflate's fast path (~2-3x zlib inflate, SIMD CRC32). htslib links
// libdeflate the same way when present; fall back to zlib otherwise.
#if !defined(SCTAG_NO_LIBDEFLATE) && __has_include(<libdeflate.h>)
#include <libdeflate.h>
#define SCTAG_HAVE_LIBDEFLATE 1
#endif

namespace {

// The 28-byte BGZF EOF marker every intact BGZF file ends with (SAM spec
// §4.1.2). Its absence means the file was truncated mid-stream — htslib and
// pysam warn the same way; parsing proceeds (the reference behaves likewise).
const unsigned char kBgzfEof[28] = {
    0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff,
    0x06, 0x00, 0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00};

bool has_bgzf_eof(const char* path) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp) return true;  // unreadable: let the main path report it
    unsigned char tail[28];
    bool ok = std::fseek(fp, -28, SEEK_END) == 0 &&
              std::fread(tail, 1, 28, fp) == 28 &&
              std::memcmp(tail, kBgzfEof, 28) == 0;
    std::fclose(fp);
    return ok;
}

struct BlockIdx {
    int64_t coff;    // compressed offset of the member start
    int32_t csize;   // whole member size (BSIZE + 1)
    int32_t isize;   // uncompressed payload size
};

// Walk BGZF member headers (no inflation) to index every block.
// A generic gzip file (no BC subfield) gets isize = -1 blocks, which the
// engine rejects with a clear error (plain-gzip BAMs are not BGZF).
int index_blocks(FILE* fp, std::vector<BlockIdx>& out, std::string& err) {
    unsigned char hdr[12];
    int64_t off = 0;
    if (std::fseek(fp, 0, SEEK_SET) != 0) { err = "seek failed"; return 1; }
    for (;;) {
        size_t got = std::fread(hdr, 1, 12, fp);
        if (got == 0) break;  // clean EOF
        if (got < 12 || hdr[0] != 0x1f || hdr[1] != 0x8b || hdr[2] != 8) {
            err = "corrupt BGZF stream (bad member header)";
            return 1;
        }
        if (!(hdr[3] & 4)) {  // FEXTRA absent: not BGZF
            err = "not BGZF (gzip member without extra field)";
            return 1;
        }
        uint16_t xlen;
        std::memcpy(&xlen, hdr + 10, 2);
        std::vector<unsigned char> extra(xlen);
        if (std::fread(extra.data(), 1, xlen, fp) != xlen) {
            err = "truncated BGZF extra field";
            return 1;
        }
        int32_t bsize = -1;
        size_t j = 0;
        while (j + 4 <= xlen) {
            uint16_t slen;
            std::memcpy(&slen, extra.data() + j + 2, 2);
            if (extra[j] == 66 && extra[j + 1] == 67 && slen == 2) {
                uint16_t bs;
                std::memcpy(&bs, extra.data() + j + 4, 2);
                bsize = (int32_t)bs + 1;
            }
            j += 4 + slen;
        }
        if (bsize < 0) {
            err = "not BGZF (no BC subfield)";
            return 1;
        }
        // ISIZE = last 4 bytes of the member
        if (std::fseek(fp, off + bsize - 4, SEEK_SET) != 0) {
            err = "truncated BGZF member";
            return 1;
        }
        uint32_t isize;
        if (std::fread(&isize, 1, 4, fp) != 4) {
            err = "truncated BGZF member (no ISIZE)";
            return 1;
        }
        out.push_back(BlockIdx{off, bsize, (int32_t)isize});
        off += bsize;
        if (std::fseek(fp, off, SEEK_SET) != 0) break;
    }
    return 0;
}

// Inflate blocks [b0, b1) of the index into `dst` (contiguous, sized by the
// blocks' summed isize) using `nthreads` workers. Validates CRC32 + ISIZE.
int inflate_window(FILE* fp, const std::vector<BlockIdx>& blocks, size_t b0,
                   size_t b1, unsigned char* dst,
                   const std::vector<int64_t>& dst_off, int nthreads,
                   std::string& err) {
    if (b0 >= b1) return 0;
    // read the window's compressed bytes in one sequential pass
    int64_t c0 = blocks[b0].coff;
    int64_t c1 = blocks[b1 - 1].coff + blocks[b1 - 1].csize;
    std::vector<unsigned char> comp((size_t)(c1 - c0));
    if (std::fseek(fp, c0, SEEK_SET) != 0 ||
        std::fread(comp.data(), 1, comp.size(), fp) != comp.size()) {
        err = "truncated BGZF stream (short read)";
        return 1;
    }
    std::atomic<size_t> next(b0);
    std::atomic<int> bad(0);
    int nw = nthreads < 1 ? 1 : nthreads;
    if ((size_t)nw > b1 - b0) nw = (int)(b1 - b0);
    std::vector<std::string> errs(nw);
    auto worker = [&](int wid) {
#ifdef SCTAG_HAVE_LIBDEFLATE
        libdeflate_decompressor* zd = libdeflate_alloc_decompressor();
        if (!zd) { bad = 1; return; }
#else
        z_stream zs;
        std::memset(&zs, 0, sizeof(zs));
        if (inflateInit2(&zs, -15) != Z_OK) { bad = 1; return; }
#endif
        for (;;) {
            size_t b = next.fetch_add(1);
            if (b >= b1 || bad.load()) break;
            const BlockIdx& blk = blocks[b];
            const unsigned char* src = comp.data() + (blk.coff - c0);
            // locate the deflate payload: fixed 12B header + XLEN
            uint16_t xlen;
            std::memcpy(&xlen, src + 10, 2);
            const unsigned char* payload = src + 12 + xlen;
            size_t paylen = (size_t)blk.csize - 12 - xlen - 8;
            unsigned char* out = dst + dst_off[b - b0];
#ifdef SCTAG_HAVE_LIBDEFLATE
            size_t got = 0;
            libdeflate_result rc = libdeflate_deflate_decompress(
                zd, payload, paylen, out, (size_t)blk.isize, &got);
            if (rc != LIBDEFLATE_SUCCESS || got != (size_t)blk.isize) {
                errs[wid] = "corrupt BGZF block (inflate failed)";
                bad = 1;
                break;
            }
            uint32_t got_crc =
                (uint32_t)libdeflate_crc32(0, out, (size_t)blk.isize);
#else
            inflateReset(&zs);
            zs.next_in = const_cast<unsigned char*>(payload);
            zs.avail_in = (uInt)paylen;
            zs.next_out = out;
            zs.avail_out = (uInt)blk.isize;
            int rc = inflate(&zs, Z_FINISH);
            if (!((rc == Z_STREAM_END && zs.avail_out == 0) ||
                  (blk.isize == 0 && (rc == Z_STREAM_END || rc == Z_BUF_ERROR)))) {
                errs[wid] = "corrupt BGZF block (inflate failed)";
                bad = 1;
                break;
            }
            uint32_t got_crc =
                crc32(crc32(0, nullptr, 0), out, (uInt)blk.isize);
#endif
            uint32_t want_crc;
            std::memcpy(&want_crc, src + blk.csize - 8, 4);
            if (got_crc != want_crc) {
                errs[wid] = "corrupt BGZF block (CRC32 mismatch)";
                bad = 1;
                break;
            }
        }
#ifdef SCTAG_HAVE_LIBDEFLATE
        libdeflate_free_decompressor(zd);
#else
        inflateEnd(&zs);
#endif
    };
    std::vector<std::thread> pool;
    for (int w = 1; w < nw; w++) pool.emplace_back(worker, w);
    worker(0);
    for (auto& t : pool) t.join();
    if (bad.load()) {
        err = "corrupt BGZF stream";
        for (const auto& e : errs)
            if (!e.empty()) { err = e; break; }
        return 1;
    }
    return 0;
}

struct Result {
    std::string barcodes;         // newline-joined, first-appearance order
    std::vector<int64_t> counts;  // parallel to barcodes
    std::vector<int64_t> firsts;  // first local kept-barcode index
    int64_t total = 0;            // kept (mapped, flag<=256) records
    int64_t spill = 0;            // bytes consumed past comp_end
    int64_t found_skip = 0;       // self-sync: discovered record boundary
    std::string error;
};

// Validate a candidate record boundary by walking the record chain from `p`:
// each step checks block_size plausibility, refID/pos/l_read_name/l_seq field
// ranges, that the fixed layout fits block_size, and that the read name is
// NUL-terminated. STRICTLY requires `need` chained records to validate —
// accepting a shorter chain that merely runs off the buffer is unsafe (a
// garbage block_size that jumps past the window would "validate"), so
// candidates near a too-small buffer fail and the caller falls back to the
// blocking spill handoff. A false accept needs a garbage record whose
// block_size lands EXACTLY on a true record boundary AND whose fields all
// pass (~1e-8 per candidate); the caller reconciles against the
// authoritative spill afterwards regardless.
bool validate_chain(const unsigned char* p, size_t avail, int need) {
    size_t off = 0;
    int ok = 0;
    while (ok < need) {
        if (off + 4 + 36 > avail) return false;  // strict: no tail credit
        int32_t bs;
        std::memcpy(&bs, p + off, 4);
        if (bs < 32 || bs > (256 << 20)) return false;
        const unsigned char* r = p + off + 4;
        int32_t ref_id, pos, l_seq, next_ref, next_pos;
        std::memcpy(&ref_id, r, 4);
        std::memcpy(&pos, r + 4, 4);
        uint8_t l_read_name = r[8];
        uint16_t n_cigar;
        std::memcpy(&n_cigar, r + 12, 2);
        std::memcpy(&l_seq, r + 16, 4);
        std::memcpy(&next_ref, r + 20, 4);
        std::memcpy(&next_pos, r + 24, 4);
        if (ref_id < -1 || ref_id > 100000000) return false;
        if (next_ref < -1 || next_ref > 100000000) return false;
        if (pos < -1 || next_pos < -1) return false;
        if (l_read_name < 2) return false;  // >= 1 char + NUL
        if (l_seq < 0) return false;
        size_t fixed = 32 + (size_t)l_read_name + 4ull * n_cigar +
                       ((size_t)l_seq + 1) / 2 + (size_t)l_seq;
        if (fixed > (size_t)bs) return false;
        if (off + 4 + 32 + l_read_name <= avail &&
            r[32 + l_read_name - 1] != 0)
            return false;  // name must be NUL-terminated
        ok++;
        off += 4 + (size_t)bs;
    }
    return true;
}

// Self-synchronization: find the first BAM record boundary in [p, p+avail)
// (the previous shard's final record may spill into this shard's bytes).
// Candidates are byte offsets tried in order; the first whose record chain
// validates wins. Returns -1 if none validates (e.g. a record larger than
// the probe window, or a shard with fewer than `need` records — callers
// fall back to the blocking spill handoff).
int64_t find_record_start(const unsigned char* p, size_t avail, int need) {
    if (avail == 0) return 0;
    if (avail < 4 + 36) return -1;
    size_t limit = avail - (4 + 36);
    for (size_t c = 0; c <= limit; c++) {
        if (validate_chain(p + c, avail - c, need)) return (int64_t)c;
    }
    return -1;
}

// Open-addressing barcode counter keyed by raw bytes (no per-record
// std::string allocation on the ~100ns/record hot path; unordered_map's
// temporary-key find() was the parse bottleneck at >3M records/s).
struct BcTable {
    std::vector<int32_t> slots;      // index into order, -1 empty
    std::vector<std::string> order;  // first-appearance
    std::vector<int64_t> counts;
    std::vector<int64_t> firsts;
    size_t mask;

    BcTable() : slots(1 << 16, -1), mask((1 << 16) - 1) {}

    // Two unaligned 8-byte loads (head + tail, overlapping for n in 9..15)
    // + three multiplies — ~6x cheaper than byte-at-a-time FNV on the
    // 16-char barcodes that dominate the hot path. Purely internal (table
    // layout only), so the mix can be anything with decent diffusion.
    static uint64_t hash(const char* s, size_t n) {
        uint64_t a = 0, b = 0;
        if (n >= 8) {
            std::memcpy(&a, s, 8);
            std::memcpy(&b, s + n - 8, 8);
        } else if (n > 0) {
            std::memcpy(&a, s, n);
            b = (uint64_t)s[n - 1] << 56;
        }
        uint64_t h = (a ^ 0x9e3779b97f4a7c15ull) * 0xff51afd7ed558ccdull;
        h ^= (b + n) * 0xc4ceb9fe1a85ec53ull;
        h ^= h >> 33;
        return h * 0xff51afd7ed558ccdull;
    }

    void grow() {
        size_t ns = (mask + 1) * 2;
        std::vector<int32_t> fresh(ns, -1);
        for (int32_t idx : slots) {
            if (idx < 0) continue;
            const std::string& b = order[(size_t)idx];
            size_t p = hash(b.data(), b.size()) & (ns - 1);
            while (fresh[p] >= 0) p = (p + 1) & (ns - 1);
            fresh[p] = idx;
        }
        slots.swap(fresh);
        mask = ns - 1;
    }

    void add(const char* s, size_t n, int64_t first_idx) {
        size_t p = hash(s, n) & mask;
        for (;;) {
            int32_t idx = slots[p];
            if (idx < 0) {
                if (order.size() * 2 > mask) {  // load factor 0.5
                    grow();
                    add(s, n, first_idx);
                    return;
                }
                slots[p] = (int32_t)order.size();
                order.emplace_back(s, n);
                counts.push_back(1);
                firsts.push_back(first_idx);
                return;
            }
            const std::string& b = order[(size_t)idx];
            if (b.size() == n && std::memcmp(b.data(), s, n) == 0) {
                counts[(size_t)idx]++;
                return;
            }
            p = (p + 1) & mask;
        }
    }
};

// Streaming view over the shard's uncompressed bytes: window-batched
// parallel inflation + a carry buffer for records crossing windows.
// Blocks [start, end_block) are the shard's OWN blocks (parallel inflate);
// blocks past end_block are continuation blocks, inflated one at a time
// only when the shard's final record spills across the boundary.
//
// Pipeline: a background prefetch thread inflates the NEXT window while the
// (single-threaded) record walk consumes the current one, so both host
// cores stay busy — inflate and parse overlap instead of alternating.
struct ShardStream {
    FILE* fp = nullptr;  // owned; prefetch thread reads it (serialized by
                         // join-before-relaunch, never concurrent)
    const std::vector<BlockIdx>* blocks = nullptr;
    size_t next_block = 0, end_block = 0, n_blocks = 0;
    int nthreads = 1;
    std::vector<unsigned char> buf;
    size_t pos = 0;  // read cursor in buf
    std::string err;
    std::thread pre;
    std::vector<unsigned char> pre_buf;
    bool pre_ok = false;
    std::string pre_err;
    static const size_t kWindowBytes = 32u << 20;  // uncompressed per window
    // Windows are inflated at a fixed offset so the previous window's small
    // unread tail (a partial record) can be copied in FRONT of the new data
    // and the buffers swapped — avoiding a full-window memcpy per refill
    // (was ~10% of the parse thread's time). Tails larger than the headroom
    // (a >1 MiB record) fall back to the append path.
    static const size_t kHeadroom = 1u << 20;

    ~ShardStream() {
        shutdown();
        if (fp) std::fclose(fp);
    }

    void shutdown() {
        if (pre.joinable()) pre.join();
    }

    // Inflate the next window into dst at kHeadroom; advances next_block.
    // Returns false at stream end (perr empty) or error (perr set).
    bool produce(std::vector<unsigned char>& dst, std::string& perr) {
        if (next_block >= n_blocks) return false;
        bool cont = next_block >= end_block;
        size_t limit = cont ? next_block + 1 : end_block;
        size_t b0 = next_block;
        size_t b1 = b0;
        size_t bytes = 0;
        std::vector<int64_t> offs;
        while (b1 < limit && bytes < kWindowBytes) {
            offs.push_back((int64_t)(kHeadroom + bytes));
            bytes += (size_t)(*blocks)[b1].isize;
            b1++;
        }
        if (b1 == b0) return false;
        dst.resize(kHeadroom + bytes);
        if (inflate_window(fp, *blocks, b0, b1, dst.data(), offs,
                           cont ? 1 : nthreads, perr))
            return false;
        next_block = b1;
        return true;
    }

    // Refill: keep the unread tail, splice in the next window (prefetched if
    // one is in flight), then launch the next prefetch.
    bool refill() {
        std::vector<unsigned char>* w;  // next window, data at kHeadroom
        std::vector<unsigned char> local;
        if (pre.joinable()) {
            pre.join();
            if (!pre_ok) {
                if (!pre_err.empty()) err = pre_err;
                return false;
            }
            w = &pre_buf;
        } else {
            if (!produce(local, err)) return false;
            w = &local;
        }
        size_t tail = buf.size() - pos;
        if (tail <= kHeadroom) {
            std::memcpy(w->data() + kHeadroom - tail, buf.data() + pos, tail);
            buf.swap(*w);
            pos = kHeadroom - tail;
        } else {  // giant partial record: append (rare)
            buf.erase(buf.begin(), buf.begin() + (ptrdiff_t)pos);
            pos = 0;
            buf.insert(buf.end(), w->begin() + (ptrdiff_t)kHeadroom, w->end());
        }
        w->clear();
        if (next_block < end_block) {  // prefetch own blocks only
            pre_ok = false;
            pre_err.clear();
            pre = std::thread([this] { pre_ok = produce(pre_buf, pre_err); });
        }
        return true;
    }

    // Ensure >= n unread bytes available; false on EOF/error.
    bool want(size_t n) {
        while (buf.size() - pos < n) {
            if (!refill()) return false;
        }
        return true;
    }
};

void parse_record(const unsigned char* p, size_t block_size, Result& out,
                  BcTable& table, int64_t& kept_bc) {
    int32_t ref_id;
    std::memcpy(&ref_id, p, 4);
    uint8_t l_read_name = p[8];
    uint16_t n_cigar_op;
    std::memcpy(&n_cigar_op, p + 12, 2);
    uint16_t flag;
    std::memcpy(&flag, p + 14, 2);
    int32_t l_seq;
    std::memcpy(&l_seq, p + 16, 4);

    if (ref_id < 0) return;  // unmapped: pysam fetch(contig) never sees it
    if (flag > 256) return;  // reference scTagger.py:458
    out.total++;

    const char* rec = reinterpret_cast<const char*>(p);
    size_t aux = 32 + l_read_name + 4ull * n_cigar_op +
                 (static_cast<size_t>(l_seq) + 1) / 2 +
                 static_cast<size_t>(l_seq);
    const size_t end = block_size;
    const char* cb = nullptr;
    size_t cb_len = 0;
    while (aux + 3 <= end) {
        char t0 = rec[aux], t1 = rec[aux + 1];
        char type = rec[aux + 2];
        aux += 3;
        size_t vlen = 0;
        switch (type) {
            case 'A': case 'c': case 'C': vlen = 1; break;
            case 's': case 'S': vlen = 2; break;
            case 'i': case 'I': case 'f': vlen = 4; break;
            case 'Z': case 'H': {
                size_t s = aux;
                const void* nul = std::memchr(rec + aux, '\0', end - aux);
                aux = nul ? (size_t)((const char*)nul - rec) : end;
                if (t0 == 'C' && t1 == 'B') {
                    cb = rec + s;
                    cb_len = aux - s;
                }
                aux++;  // NUL
                continue;
            }
            case 'B': {
                if (aux + 5 > end) { aux = end; continue; }
                char sub = rec[aux];
                int32_t cnt;
                std::memcpy(&cnt, rec + aux + 1, 4);
                size_t esz = (sub == 'c' || sub == 'C') ? 1
                           : (sub == 's' || sub == 'S') ? 2 : 4;
                aux += 5 + esz * static_cast<size_t>(cnt);
                continue;
            }
            default:
                aux = end;  // unknown type: stop scanning this record
                continue;
        }
        aux += vlen;
    }
    if (cb == nullptr) return;  // no CB: total counted, no barcode
    const void* d = std::memchr(cb, '-', cb_len);
    size_t dash = d ? (size_t)((const char*)d - cb) : cb_len;
    if (dash == 2 && cb[0] == 'N' && cb[1] == 'A') return;
    table.add(cb, dash, kept_bc);
    kept_bc++;
}

// Core engine. comp_end < 0 => whole file. parse_header: this shard starts
// at the BAM header (host 0 / single host). skip: uncompressed bytes to
// drop first (previous shard's spill).
int extract_range(const char* path, int64_t comp_start, int64_t comp_end,
                  int64_t skip, bool parse_header, int nthreads,
                  Result& out) {
    if (parse_header && !has_bgzf_eof(path)) {
        std::fprintf(stderr,
                     "[sctag_io] warning: no BGZF EOF marker in %s; "
                     "the file may be truncated\n", path);
    }
    FILE* fp = std::fopen(path, "rb");
    if (!fp) {
        out.error = "cannot open file";
        return 1;
    }
    ShardStream st;
    st.fp = fp;  // owned: closed (and prefetch joined) by the destructor
    std::vector<BlockIdx> blocks;
    if (index_blocks(fp, blocks, out.error)) {
        return 1;
    }
    st.blocks = &blocks;
    st.n_blocks = blocks.size();
    st.nthreads = nthreads < 1 ? 1 : nthreads;
    // map the compressed range to block indices
    size_t b = 0;
    while (b < blocks.size() && blocks[b].coff < comp_start) b++;
    st.next_block = b;
    if (comp_end < 0) {
        st.end_block = blocks.size();
    } else {
        size_t e = b;
        while (e < blocks.size() && blocks[e].coff < comp_end) e++;
        st.end_block = e;
    }

    // the shard owns records whose START offset (in the shard-local
    // uncompressed stream, counting from its first own block) is < own_end;
    // spill = bytes its final record(s) consume past own_end
    int64_t own_end = 0;
    for (size_t i = st.next_block; i < st.end_block; i++)
        own_end += blocks[i].isize;
    int64_t consumed = 0;

    BcTable table;
    int64_t kept_bc = 0;

    if (parse_header) {
        if (!st.want(12)) {
            out.error = out.error.empty() ? st.err : out.error;
            if (out.error.empty()) out.error = "not a BAM file (empty)";
            return 1;
        }
        if (std::memcmp(st.buf.data() + st.pos, "BAM\x01", 4) != 0) {
            out.error = "not a BAM file (bad magic)";
            return 1;
        }
        int32_t l_text;
        std::memcpy(&l_text, st.buf.data() + st.pos + 4, 4);
        if (!st.want(12 + (size_t)l_text)) {
            out.error = "truncated BAM header";
            return 1;
        }
        int32_t n_ref;
        std::memcpy(&n_ref, st.buf.data() + st.pos + 8 + l_text, 4);
        st.pos += 12 + (size_t)l_text;
        consumed += 12 + (int64_t)l_text;
        for (int32_t i = 0; i < n_ref; i++) {
            if (!st.want(4)) { out.error = "truncated BAM header"; return 1; }
            int32_t l_name;
            std::memcpy(&l_name, st.buf.data() + st.pos, 4);
            if (!st.want(8 + (size_t)l_name)) { out.error = "truncated BAM header"; return 1; }
            st.pos += 8 + (size_t)l_name;
            consumed += 8 + (int64_t)l_name;
        }
    } else if (skip == -1) {
        // self-synchronize (stages/extract_sr_bc.py parallel protocol): do
        // NOT wait for the previous shard's spill — discover the first
        // record boundary by validating a chained record walk, scan
        // immediately, and let the caller reconcile the discovered offset
        // against the authoritative spill when it arrives. rc=2 signals
        // "no boundary found" (the caller falls back to the spill handoff).
        size_t target = own_end < (16 << 20) ? (size_t)own_end : (16u << 20);
        if (target > 0 && !st.want(target) && !st.err.empty()) {
            out.error = st.err;
            return 1;
        }
        int64_t found =
            find_record_start(st.buf.data() + st.pos, st.buf.size() - st.pos,
                              /*need=*/8);
        if (found < 0) {
            out.error = "self-sync found no valid record boundary";
            return 2;
        }
        st.pos += (size_t)found;
        consumed += found;
        out.found_skip = found;
    } else if (skip > 0) {
        // drop the previous shard's spill; a skip larger than this shard
        // (a record bigger than the whole shard) just forwards the excess
        if (st.want((size_t)skip)) st.pos += (size_t)skip;
        else if (!st.err.empty()) { out.error = st.err; return 1; }
        consumed += skip;
    }

    while (consumed < own_end) {
        if (!st.want(4)) {
            if (!st.err.empty()) { out.error = st.err; return 1; }
            break;  // clean end of stream
        }
        int32_t block_size;
        std::memcpy(&block_size, st.buf.data() + st.pos, 4);
        if (block_size < 32) {
            out.error = "corrupt record (block_size too small)";
            return 1;
        }
        if (!st.want(4 + (size_t)block_size)) {
            if (!st.err.empty()) { out.error = st.err; return 1; }
            out.error = "truncated record";
            return 1;
        }
        parse_record(st.buf.data() + st.pos + 4, (size_t)block_size, out,
                     table, kept_bc);
        st.pos += 4 + (size_t)block_size;
        consumed += 4 + (int64_t)block_size;
    }
    st.shutdown();
    // spill = bytes this shard's records consumed past its own blocks
    out.spill = consumed > own_end ? consumed - own_end : 0;

    for (size_t i = 0; i < table.order.size(); i++) {
        out.barcodes += table.order[i];
        out.barcodes += '\n';
    }
    out.counts = std::move(table.counts);
    out.firsts = std::move(table.firsts);
    return 0;
}

}  // namespace

extern "C" {

// Returns 0 on success. Caller must free via sctag_free.
// On success: *barcodes = newline-joined unique barcodes (first-appearance
// order), *counts = int64 array (len *n_unique), *total = kept records.
int sctag_extract_cb(const char* path, char** barcodes, int64_t** counts,
                     int64_t* n_unique, int64_t* total, char** error) {
    Result r;
    const char* nt = std::getenv("SCTAG_BAM_THREADS");
    // Default to cores+1: the inflate workers idle briefly at every window
    // join, so slight oversubscription keeps both the parse thread and the
    // cores fed (measured +25% over cores threads on a 2-core host).
    int nthreads = nt ? std::atoi(nt)
                      : (int)std::thread::hardware_concurrency() + 1;
    int rc = extract_range(path, 0, -1, 0, /*parse_header=*/true,
                           nthreads, r);
    *error = nullptr;
    if (rc != 0) {
        *error = static_cast<char*>(std::malloc(r.error.size() + 1));
        std::memcpy(*error, r.error.c_str(), r.error.size() + 1);
        *barcodes = nullptr;
        *counts = nullptr;
        *n_unique = 0;
        *total = 0;
        return rc;
    }
    *barcodes = static_cast<char*>(std::malloc(r.barcodes.size() + 1));
    std::memcpy(*barcodes, r.barcodes.c_str(), r.barcodes.size() + 1);
    *counts = static_cast<int64_t*>(
        std::malloc(sizeof(int64_t) * (r.counts.size() ? r.counts.size() : 1)));
    std::memcpy(*counts, r.counts.data(), sizeof(int64_t) * r.counts.size());
    *n_unique = static_cast<int64_t>(r.counts.size());
    *total = r.total;
    return 0;
}

// Sharded scan for --n-hosts execution (stages/extract_sr_bc.py): process
// records starting in compressed range [comp_start, comp_end) after
// dropping `skip` spill bytes from the previous shard. Additionally
// returns each barcode's FIRST local kept-barcode index (*firsts) and the
// local kept-barcode record count (*n_kept_bc) so hosts can reconstruct the
// global first-appearance order, plus *spill for the next shard.
// parse_header must be 1 for the shard containing offset 0.
// skip == -1 self-synchronizes (no upstream wait): the discovered boundary
// offset lands in *found_skip for the caller to reconcile against the true
// spill; rc == 2 means no boundary was found (fall back to a blocking skip).
int sctag_extract_cb_range(const char* path, int64_t comp_start,
                           int64_t comp_end, int64_t skip, int parse_header,
                           int nthreads, char** barcodes, int64_t** counts,
                           int64_t** firsts, int64_t* n_unique,
                           int64_t* total, int64_t* n_kept_bc,
                           int64_t* spill, int64_t* found_skip,
                           char** error) {
    Result r;
    int rc = extract_range(path, comp_start, comp_end, skip,
                           parse_header != 0, nthreads, r);
    *error = nullptr;
    *found_skip = r.found_skip;
    if (rc != 0) {
        *error = static_cast<char*>(std::malloc(r.error.size() + 1));
        std::memcpy(*error, r.error.c_str(), r.error.size() + 1);
        *barcodes = nullptr;
        *counts = nullptr;
        *firsts = nullptr;
        *n_unique = 0;
        *total = 0;
        *n_kept_bc = 0;
        *spill = 0;
        return rc;
    }
    *barcodes = static_cast<char*>(std::malloc(r.barcodes.size() + 1));
    std::memcpy(*barcodes, r.barcodes.c_str(), r.barcodes.size() + 1);
    size_t n = r.counts.size();
    *counts = static_cast<int64_t*>(std::malloc(sizeof(int64_t) * (n ? n : 1)));
    std::memcpy(*counts, r.counts.data(), sizeof(int64_t) * n);
    *firsts = static_cast<int64_t*>(std::malloc(sizeof(int64_t) * (n ? n : 1)));
    std::memcpy(*firsts, r.firsts.data(), sizeof(int64_t) * n);
    *n_unique = static_cast<int64_t>(n);
    *total = r.total;
    int64_t kept = 0;
    for (size_t i = 0; i < n; i++) kept += r.counts[i];
    *n_kept_bc = kept;
    *spill = r.spill;
    return 0;
}

// Compressed file size aligned helper: hosts shard [0, size) byte ranges.
int64_t sctag_file_size(const char* path) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp) return -1;
    std::fseek(fp, 0, SEEK_END);
    int64_t n = std::ftell(fp);
    std::fclose(fp);
    return n;
}

void sctag_free(void* p) { std::free(p); }

}  // extern "C"
