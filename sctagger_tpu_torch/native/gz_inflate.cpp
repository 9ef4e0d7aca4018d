// Whole-file read of a (gzip) text file into one byte buffer, for the alt
// stage's whitelist (io/whitelist.py): the decompressed bytes as they are,
// with no object per line.
//
// gz = 1 follows Python's gzip module, which the reference's reader uses:
// any number of members, each checked by its CRC32 and ISIZE; zero bytes
// after a member are padding; anything else after a member, a member cut
// short or a file that does not start with a member is an error. An empty
// file is empty. gz = 0 gives the file's bytes.
//
// Members inflate one after another, by zlib's inflate, into one buffer
// that grows when it fills; inflate resumes where it stopped.
//
// Build: g++ -O2 -shared -fPIC gz_inflate.cpp -o libgz.so -lz

#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <zlib.h>

namespace {

char* gzi_err(const char* m) {
    char* e = (char*)std::malloc(std::strlen(m) + 1);
    if (e) std::strcpy(e, m);
    return e;
}

// calloc-backed output: first-touch writes to calloc'd pages are cheap where
// plain malloc pages are not (fastq_reader.cpp's Buf); freed with sctag_free
struct Out {
    unsigned char* p = nullptr;
    size_t n = 0, cap = 0;

    ~Out() { std::free(p); }

    bool grow(size_t want) {
        if (want <= cap) return true;
        size_t c = cap ? cap * 2 : (size_t)1 << 20;
        if (c < want) c = want;
        unsigned char* q = (unsigned char*)std::calloc(c, 1);
        if (!q) return false;
        if (n) std::memcpy(q, p, n);
        std::free(p);
        p = q;
        cap = c;
        return true;
    }
};

bool read_all(const char* path, Out& o) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp) return false;
    bool ok = std::fseek(fp, 0, SEEK_END) == 0;
    long sz = ok ? std::ftell(fp) : -1;
    ok = sz >= 0 && std::fseek(fp, 0, SEEK_SET) == 0 && o.grow((size_t)sz + 1);
    if (ok) {
        o.n = std::fread(o.p, 1, (size_t)sz, fp);
        ok = o.n == (size_t)sz;
    }
    std::fclose(fp);
    return ok;
}

// Past a member: skip its zero padding. Returns the next member's offset,
// `len` at the end of the file, or -1 when what follows is not a member.
int64_t next_member(const unsigned char* in, size_t len, size_t pos) {
    while (pos < len && in[pos] == 0) ++pos;
    if (pos == len) return (int64_t)len;
    if (len - pos < 2 || in[pos] != 0x1f || in[pos + 1] != 0x8b) return -1;
    return (int64_t)pos;
}

const char* inflate_members(const unsigned char* in, size_t len, Out& o) {
    z_stream zs;
    std::memset(&zs, 0, sizeof zs);
    if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) return "zlib init failed";
    const char* err = nullptr;
    size_t pos = 0;
    while (pos < len && !err) {
        for (;;) {
            if (o.n == o.cap && !o.grow(o.cap + 1)) { err = "out of memory"; break; }
            size_t in_left = len - pos, out_left = o.cap - o.n;
            zs.next_in = (Bytef*)(in + pos);
            zs.avail_in = (uInt)(in_left < UINT_MAX ? in_left : UINT_MAX);
            zs.next_out = o.p + o.n;
            zs.avail_out = (uInt)(out_left < UINT_MAX ? out_left : UINT_MAX);
            uInt avail_in = zs.avail_in, avail_out = zs.avail_out;
            int rc = inflate(&zs, Z_NO_FLUSH);
            pos += avail_in - zs.avail_in;
            o.n += avail_out - zs.avail_out;
            if (rc == Z_STREAM_END) break;
            // Z_BUF_ERROR with the buffer full: grow it and go on; with input
            // left to read and room to write: the member was cut short
            if (rc == Z_OK || (rc == Z_BUF_ERROR && o.n == o.cap)) continue;
            err = "corrupt or truncated gzip member";
            break;
        }
        if (err) break;
        int64_t nxt = next_member(in, len, pos);
        if (nxt < 0) { err = "not a gzip member after a member"; break; }
        pos = (size_t)nxt;
        if (inflateReset(&zs) != Z_OK) err = "zlib reset failed";
    }
    inflateEnd(&zs);
    return err;
}

}  // namespace

extern "C" {

// Returns 0 on success: *out (freed with sctag_free, never null) holds
// *out_len bytes. Else 1 and *error (freed with sctag_free) says why.
int sctag_inflate_file(const char* path, int gz, char** out, int64_t* out_len,
                       char** error) {
    Out raw;
    if (!read_all(path, raw)) {
        *error = gzi_err("cannot read the file");
        return 1;
    }
    Out res;
    Out& o = gz ? res : raw;
    if (gz && raw.n) {
        if (raw.n < 2 || raw.p[0] != 0x1f || raw.p[1] != 0x8b) {
            *error = gzi_err("not a gzip file");
            return 1;
        }
        // one member, as 10x ships it: its ISIZE is the whole size; many: grown
        uint32_t isize = 0;
        if (raw.n >= 4) std::memcpy(&isize, raw.p + raw.n - 4, 4);
        size_t guess = (size_t)isize + 1;
        if (!res.grow(guess > 3 * raw.n ? guess : 3 * raw.n)) {
            *error = gzi_err("out of memory");
            return 1;
        }
        const char* err = inflate_members(raw.p, raw.n, res);
        if (err) {
            *error = gzi_err(err);
            return 1;
        }
    }
    if (!o.grow(1)) {
        *error = gzi_err("out of memory");
        return 1;
    }
    *out_len = (int64_t)o.n;
    *out = (char*)o.p;
    o.p = nullptr;
    return 0;
}

}  // extern "C"
