// gossio — native sequence-file reader for gossamer_tpu.
//
// Streams FASTA/FASTQ/line files (plain or gzip, via zlib's gz* layer)
// into flat 2-bit code chunks with 0xFF separators — the host-side
// counterpart of the reference's BackgroundLineSource + parser +
// GossReadSequence pull chain (src/LineSource.cc, src/FastqParser.hh),
// feeding the device kmerization pipeline without Python parsing costs.
//
// A background producer thread parses/encodes ahead of the consumer
// through a small ring of buffers (the reference's BoundedQueue pattern,
// src/BoundedQueue.hh:54-170).
//
// C ABI (ctypes):
//   gossio_stream* gossio_open(const char** paths, int n, int fmt,
//                              int threads);
//       fmt: 0 = sniff per file, 1 = fasta, 2 = fastq, 3 = lines
//       threads: producer parser threads (clamped to [1, n files]);
//       with threads > 1, whole files are parsed concurrently and their
//       read-aligned blocks interleave in the output stream (order
//       within a file is preserved; counting consumers are
//       order-insensitive)
//   long gossio_next_chunk(gossio_stream*, uint8_t* buf, long chunk,
//                          int overlap);
//       Fills buf[0 .. chunk+overlap-1]. Returns the number of window
//       start positions with real data (== chunk except on the final
//       chunk), or 0 at end of stream.
//   long gossio_next_packed(gossio_stream*, uint32_t* words,
//                           uint8_t* inval, long chunk, int overlap);
//       Packed-transfer variant (0.375 B/base on the wire): fills
//       words[0 .. chunk/16 + 1] with the 2-bit base stream packed
//       big-endian (base p at bits [30 - 2*(p%16), +2) of word p/16)
//       and inval[0 .. ceil((chunk+overlap)/8)-1] with the little-endian
//       invalid-code bitmap.  chunk must be a multiple of 16 and
//       overlap <= 32.  Same return convention as gossio_next_chunk.
//   void gossio_close(gossio_stream*);

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint8_t SEP = 0xFF;

struct EncodeTable {
    uint8_t t[256];
    EncodeTable() {
        memset(t, SEP, sizeof(t));
        t['A'] = t['a'] = 0;
        t['C'] = t['c'] = 1;
        t['G'] = t['g'] = 2;
        t['T'] = t['t'] = 3;
    }
};
const EncodeTable kEncode;

struct Block {
    std::vector<uint8_t> codes;
};

class Producer {
  public:
    Producer(std::vector<std::string> paths, int fmt, int threads)
        : paths_(std::move(paths)), fmt_(fmt), next_file_(0), live_(0),
          done_(false), stop_(false) {
        int n = (int)paths_.size();
        int t = threads < 1 ? 1 : threads;
        if (t > n) t = n > 0 ? n : 1;
        live_ = t;
        max_blocks_ = kMaxBlocksPerThread * (size_t)t;
        for (int i = 0; i < t; ++i)
            threads_.emplace_back([this] { run(); });
    }

    ~Producer() {
        {
            std::unique_lock<std::mutex> lk(mu_);
            stop_ = true;
            cv_space_.notify_all();
        }
        for (auto& th : threads_)
            if (th.joinable()) th.join();
    }

    // Pop the next encoded block; empty vector at end of stream.
    std::vector<uint8_t> pop() {
        std::unique_lock<std::mutex> lk(mu_);
        cv_data_.wait(lk, [this] { return !queue_.empty() || done_; });
        if (queue_.empty()) return {};
        std::vector<uint8_t> out = std::move(queue_.front().codes);
        queue_.pop_front();
        cv_space_.notify_one();
        return out;
    }

  private:
    void push(std::vector<uint8_t>&& codes) {
        std::unique_lock<std::mutex> lk(mu_);
        cv_space_.wait(lk,
                       [this] { return queue_.size() < max_blocks_ || stop_; });
        if (stop_) return;
        queue_.push_back(Block{std::move(codes)});
        cv_data_.notify_one();
    }

    // Worker: claim whole files off the shared counter; blocks from
    // different files interleave, each block stays read-aligned.
    void run() {
        std::vector<uint8_t> out;
        out.reserve(kBlockSize + 4096);
        for (;;) {
            size_t i = next_file_.fetch_add(1);
            if (i >= paths_.size() || stop_) break;
            gzFile f = gzopen(paths_[i].c_str(), "rb");
            if (!f) continue;
            gzbuffer(f, 1 << 20);
            int fmt = fmt_;
            parseFile(f, fmt, out);
            gzclose(f);
        }
        if (!out.empty()) push(std::move(out));
        std::unique_lock<std::mutex> lk(mu_);
        if (--live_ == 0) {
            done_ = true;
            cv_data_.notify_all();
        }
    }

    // Encode a sequence line segment, flush blocks as they fill.
    inline void encodeSeq(const char* s, size_t n, std::vector<uint8_t>& out) {
        size_t base = out.size();
        out.resize(base + n);
        uint8_t* dst = out.data() + base;
        for (size_t i = 0; i < n; ++i) dst[i] = kEncode.t[(uint8_t)s[i]];
    }

    inline void endRead(std::vector<uint8_t>& out) {
        out.push_back(SEP);
        if (out.size() >= kBlockSize) {
            push(std::move(out));
            out = {};
            out.reserve(kBlockSize + 4096);
        }
    }

    void parseFile(gzFile f, int fmt, std::vector<uint8_t>& out) {
        std::string line;
        line.reserve(1024);
        char buf[1 << 16];
        std::string carry;
        int state = 0;  // fastq line state
        bool in_seq = false;
        bool sniffed = fmt != 0;
        int eff_fmt = fmt;
        for (;;) {
            if (stop_) return;
            int n = gzread(f, buf, sizeof(buf));
            if (n <= 0) break;
            size_t start = 0;
            for (int i = 0; i < n; ++i) {
                if (buf[i] != '\n') continue;
                // line = carry + buf[start..i)
                const char* ls;
                size_t ln;
                if (carry.empty()) {
                    ls = buf + start;
                    ln = i - start;
                } else {
                    carry.append(buf + start, i - start);
                    ls = carry.data();
                    ln = carry.size();
                }
                if (ln && ls[ln - 1] == '\r') --ln;
                if (!sniffed && ln) {
                    sniffed = true;
                    eff_fmt = ls[0] == '>' ? 1 : (ls[0] == '@' ? 2 : 3);
                }
                handleLine(ls, ln, eff_fmt, state, in_seq, out);
                carry.clear();
                start = i + 1;
            }
            carry.append(buf + start, n - start);
        }
        if (!carry.empty()) {
            size_t ln = carry.size();
            if (ln && carry[ln - 1] == '\r') --ln;
            if (!sniffed && ln) {
                sniffed = true;
                eff_fmt = carry[0] == '>' ? 1 : (carry[0] == '@' ? 2 : 3);
            }
            handleLine(carry.data(), ln, eff_fmt, state, in_seq, out);
            carry.clear();
        }
        if (in_seq) {
            endRead(out);
            in_seq = false;
        }
        state = 0;
    }

    inline void handleLine(const char* ls, size_t ln, int fmt, int& state,
                           bool& in_seq, std::vector<uint8_t>& out) {
        switch (fmt) {
            case 1:  // fasta
                if (ln && ls[0] == '>') {
                    if (in_seq) endRead(out);
                    in_seq = false;
                } else if (ln) {
                    encodeSeq(ls, ln, out);
                    in_seq = true;
                }
                break;
            case 2:  // fastq: 0 header, 1 seq, 2 plus, 3 qual
                if (state == 1 && ln) {
                    encodeSeq(ls, ln, out);
                    endRead(out);
                }
                state = (state + 1) & 3;
                break;
            default:  // lines
                if (ln) {
                    encodeSeq(ls, ln, out);
                    endRead(out);
                }
        }
    }

    static constexpr size_t kBlockSize = 4 << 20;
    static constexpr size_t kMaxBlocksPerThread = 4;

    std::vector<std::string> paths_;
    int fmt_;
    size_t max_blocks_;
    std::atomic<size_t> next_file_;
    int live_;  // parser threads still running (guarded by mu_)
    std::deque<Block> queue_;
    std::mutex mu_;
    std::condition_variable cv_data_, cv_space_;
    bool done_;
    std::atomic<bool> stop_;
    std::vector<std::thread> threads_;
};

}  // namespace

extern "C" {

struct gossio_stream {
    Producer* producer;
    std::vector<uint8_t> pending;  // leftover codes not yet emitted
    size_t pending_off;
    bool primed;  // first chunk prefixes `overlap` separators
    bool eof;
};

gossio_stream* gossio_open(const char** paths, int n, int fmt, int threads) {
    std::vector<std::string> ps(paths, paths + n);
    auto* s = new gossio_stream();
    s->producer = new Producer(std::move(ps), fmt, threads);
    s->pending_off = 0;
    s->primed = false;
    s->eof = false;
    return s;
}

long gossio_next_chunk(gossio_stream* s, uint8_t* buf, long chunk, int overlap) {
    const long total = chunk + overlap;
    long filled = 0;
    if (!s->primed) {
        // stream start: overlap region is virtual separators
        memset(buf, SEP, overlap);
        filled = overlap;
        s->primed = true;
    }
    long new_positions = 0;  // count of stream codes placed this call
    while (filled < total) {
        if (s->pending_off >= s->pending.size()) {
            if (s->eof) break;
            s->pending = s->producer->pop();
            s->pending_off = 0;
            if (s->pending.empty()) {
                s->eof = true;
                break;
            }
        }
        long avail = (long)(s->pending.size() - s->pending_off);
        long need = total - filled;
        long take = avail < need ? avail : need;
        memcpy(buf + filled, s->pending.data() + s->pending_off, take);
        filled += take;
        new_positions += take;
        s->pending_off += take;
    }
    if (new_positions == 0 && filled <= overlap) return 0;  // end of stream
    long windows = filled - overlap;  // start positions with real data
    if (filled < total) memset(buf + filled, SEP, total - filled);
    // stash the tail as the next chunk's overlap prefix: the caller's
    // next buffer must begin with buf[chunk .. chunk+overlap); emulate by
    // pushing it back into pending
    if (windows > 0 && !(s->eof && s->pending_off >= s->pending.size())) {
        // prepend tail to pending
        std::vector<uint8_t> tail(buf + chunk, buf + chunk + overlap);
        if (s->pending_off > 0) {
            s->pending.erase(s->pending.begin(), s->pending.begin() + s->pending_off);
            s->pending_off = 0;
        }
        s->pending.insert(s->pending.begin(), tail.begin(), tail.end());
    }
    return windows;
}

long gossio_next_packed(gossio_stream* s, uint32_t* words, uint8_t* inval,
                        long chunk, int overlap) {
    if (chunk % 16 != 0 || overlap > 32) return -1;
    const long total = chunk + overlap;
    std::vector<uint8_t> buf(total);
    long windows = gossio_next_chunk(s, buf.data(), chunk, overlap);
    if (windows <= 0) return windows;
    const long n_words = chunk / 16 + 2;
    memset(words, 0, n_words * sizeof(uint32_t));
    memset(inval, 0, (total + 7) / 8);
    for (long p = 0; p < total; ++p) {
        uint8_t c = buf[p];
        if (c > 3) {
            inval[p >> 3] |= (uint8_t)(1u << (p & 7));
            c = 0;
        }
        words[p >> 4] |= (uint32_t)c << (30 - 2 * (p & 15));
    }
    return windows;
}

void gossio_close(gossio_stream* s) {
    delete s->producer;
    delete s;
}

// Spill-run codec: ascending (key, count) runs as key-delta + count
// varints (LEB128), the design of the reference's spill-file format
// EdgeAndCountCodec (src/EdgeAndCount.hh:78-112, delta + VByte) —
// ~5 B/key instead of 16, tripling how much spilled spectrum fits in
// host RAM.  encode returns bytes written (caller provides 20*n);
// decode returns keys decoded, or -1 on truncated input.
static inline uint8_t* put_varint(uint8_t* p, uint64_t v) {
    while (v >= 0x80) { *p++ = (uint8_t)(v | 0x80); v >>= 7; }
    *p++ = (uint8_t)v;
    return p;
}

long gossio_eac_encode(long n, const uint64_t* lo, const int64_t* c,
                       uint8_t* out) {
    uint8_t* p = out;
    uint64_t prev = 0;
    for (long i = 0; i < n; ++i) {
        p = put_varint(p, lo[i] - prev);
        prev = lo[i];
        p = put_varint(p, (uint64_t)c[i]);
    }
    return (long)(p - out);
}

long gossio_eac_decode(const uint8_t* buf, long nbytes, long n,
                       uint64_t* lo, int64_t* c) {
    const uint8_t* p = buf;
    const uint8_t* end = buf + nbytes;
    uint64_t prev = 0;
    for (long i = 0; i < n; ++i) {
        uint64_t v = 0; int sh = 0;
        while (true) {
            if (p >= end) return -1;
            uint8_t b = *p++;
            v |= (uint64_t)(b & 0x7F) << sh;
            if (!(b & 0x80)) break;
            sh += 7;
        }
        prev += v;
        lo[i] = prev;
        v = 0; sh = 0;
        while (true) {
            if (p >= end) return -1;
            uint8_t b = *p++;
            v |= (uint64_t)(b & 0x7F) << sh;
            if (!(b & 0x80)) break;
            sh += 7;
        }
        c[i] = (int64_t)v;
    }
    return n;
}

// 128-bit variant for the wide-key engine (30 < k <= 62): the delta's
// two u64 limbs each varint-coded + the count, exactly the reference
// codec's record shape (src/EdgeAndCount.hh:86-97).
long gossio_eac_encode128(long n, const uint64_t* lo, const uint64_t* hi,
                          const int64_t* c, uint8_t* out) {
    uint8_t* p = out;
    uint64_t plo = 0, phi = 0;
    for (long i = 0; i < n; ++i) {
        uint64_t dlo = lo[i] - plo;
        uint64_t dhi = hi[i] - phi - (lo[i] < plo ? 1 : 0);
        p = put_varint(p, dlo);
        p = put_varint(p, dhi);
        p = put_varint(p, (uint64_t)c[i]);
        plo = lo[i]; phi = hi[i];
    }
    return (long)(p - out);
}

long gossio_eac_decode128(const uint8_t* buf, long nbytes, long n,
                          uint64_t* lo, uint64_t* hi, int64_t* c) {
    const uint8_t* p = buf;
    const uint8_t* end = buf + nbytes;
    uint64_t plo = 0, phi = 0;
    for (long i = 0; i < n; ++i) {
        uint64_t vals[3];
        for (int f = 0; f < 3; ++f) {
            uint64_t v = 0; int sh = 0;
            while (true) {
                if (p >= end) return -1;
                uint8_t b = *p++;
                v |= (uint64_t)(b & 0x7F) << sh;
                if (!(b & 0x80)) break;
                sh += 7;
            }
            vals[f] = v;
        }
        uint64_t nlo = plo + vals[0];
        uint64_t nhi = phi + vals[1] + (nlo < plo ? 1 : 0);
        plo = nlo; phi = nhi;
        lo[i] = nlo; hi[i] = nhi; c[i] = (int64_t)vals[2];
    }
    return n;
}

// Delta-compressed spectrum reconstruction (the host side of the
// engine's device->host pull, ops/engine.py:_delta_unpack).  numpy on
// small-vCPU hosts runs the cumsum+patch formulation at ~2s per 9M
// keys; this single pass runs at memory bandwidth.  Exception records
// (exact key + count) are lane-ordered ascending; lanes >= n_out are
// beyond the live prefix and ignored.
// Canonical-class spectrum -> symmetric fwd+rc edge spectrum
// (ops/count.py:_expand_symmetric / ops/engine.py:expand_step).
// Pulling the canonical half-spectrum and expanding on the host halves
// the device->host transfer.  Input keys ascend; palindromes emit once with doubled
// count.  A canonical key can never equal the rc of a different
// canonical key (both would have to be each other's rc, i.e. equal),
// so the merge never sums.  out_lo/out_c must hold 2n lanes; returns
// the emitted count.
static inline uint64_t rev2c_u64(uint64_t x, const uint8_t* lut) {
    x = __builtin_bswap64(~x);
    uint64_t r = 0;
    for (int i = 0; i < 8; ++i)
        r |= (uint64_t)lut[(x >> (8 * i)) & 0xFF] << (8 * i);
    return r;
}

namespace {
struct ExpRec { uint64_t k; int64_t c; };

static void radix_sort_recs(std::vector<ExpRec>& rc, int key_bits) {
    std::vector<ExpRec> tmp(rc.size());
    const int B = 13, M = (1 << B) - 1;
    const int passes = (key_bits + B - 1) / B;
    for (int pass = 0; pass < passes; ++pass) {
        int sh = pass * B;
        std::vector<long> cnt(1 << B, 0);
        for (const auto& e : rc) ++cnt[(e.k >> sh) & M];
        long acc = 0;
        for (long& v : cnt) { long t = v; v = acc; acc += t; }
        for (const auto& e : rc) tmp[cnt[(e.k >> sh) & M]++] = e;
        rc.swap(tmp);
    }
}
}  // namespace

long gossio_expand_symmetric(long n, const uint64_t* lo, const int64_t* c,
                             int rho, uint64_t* out_lo, int64_t* out_c) {
    uint8_t lut[256];
    for (int b = 0; b < 256; ++b) {
        int r = ((b & 0x33) << 2) | ((b >> 2) & 0x33);
        lut[b] = (uint8_t)(((r & 0x0F) << 4) | ((r >> 4) & 0x0F));
    }
    const int shift = 64 - 2 * rho;
    const int kb = 2 * rho;
    const uint64_t half_bit = 1ULL << (kb - 1);
    std::vector<int64_t> fwd_c(c, c + n);
    // two worker threads: each scans half the input, computing rc keys
    // and bucketing them by the top key bit; bucket 0 keys all precede
    // bucket 1 keys, so per-bucket radix sorts concatenate sorted.
    std::vector<ExpRec> buck[2][2];  // [thread][top-bit]
    {
        auto scan = [&](int t, long lo_i, long hi_i) {
            buck[t][0].reserve((hi_i - lo_i) / 2 + 16);
            buck[t][1].reserve((hi_i - lo_i) / 2 + 16);
            for (long i = lo_i; i < hi_i; ++i) {
                uint64_t r = rev2c_u64(lo[i], lut) >> shift;
                if (r == lo[i]) fwd_c[i] *= 2;  // palindrome
                else buck[t][r >= half_bit].push_back({r, c[i]});
            }
        };
        std::thread th(scan, 0, 0L, n / 2);
        scan(1, n / 2, n);
        th.join();
    }
    std::vector<ExpRec> rc0, rc1;
    rc0.reserve(buck[0][0].size() + buck[1][0].size());
    rc1.reserve(buck[0][1].size() + buck[1][1].size());
    for (int t = 0; t < 2; ++t) {
        rc0.insert(rc0.end(), buck[t][0].begin(), buck[t][0].end());
        rc1.insert(rc1.end(), buck[t][1].begin(), buck[t][1].end());
        buck[t][0].clear(); buck[t][0].shrink_to_fit();
        buck[t][1].clear(); buck[t][1].shrink_to_fit();
    }
    {
        std::thread th([&] { radix_sort_recs(rc0, kb - 1); });
        radix_sort_recs(rc1, kb - 1);  // top bit constant within bucket
        th.join();
    }
    long i = 0, o = 0;
    auto merge_run = [&](const std::vector<ExpRec>& rc) {
        long j = 0;
        const long m = (long)rc.size();
        while (i < n && j < m) {
            if (lo[i] < rc[j].k) { out_lo[o] = lo[i]; out_c[o] = fwd_c[i]; ++i; }
            else { out_lo[o] = rc[j].k; out_c[o] = rc[j].c; ++j; }
            ++o;
        }
        for (; j < m; ++j, ++o) { out_lo[o] = rc[j].k; out_c[o] = rc[j].c; }
    };
    // all rc0 keys < half_bit <= all rc1 keys: merge fwd against rc0
    // until rc0 drains, then against rc1, then flush the fwd tail
    merge_run(rc0);
    merge_run(rc1);
    for (; i < n; ++i, ++o) { out_lo[o] = lo[i]; out_c[o] = fwd_c[i]; }
    return o;
}

void gossio_delta_unpack(long n_out,
                         const uint32_t* d, const uint8_t* cpack,
                         long n_exc, const uint32_t* e_lane,
                         const uint32_t* e1, const uint32_t* e0,
                         const uint32_t* ec,
                         uint64_t* lo, int64_t* c) {
    uint64_t v = 0;
    long e = 0;
    for (long i = 0; i < n_out; ++i) {
        if (e < n_exc && (long)e_lane[e] == i) {
            v = ((uint64_t)e1[e] << 32) | e0[e];
            lo[i] = v;
            c[i] = (int64_t)ec[e];
            ++e;
        } else {
            v += d[i];
            lo[i] = v;
            c[i] = (int64_t)cpack[i];
        }
    }
}
}

// ---------------------------------------------------------------------------
// Sorted-array rank (lower_bound) kernels.  np.searchsorted measured
// ~440 ns/query on 4M-key u64 arrays on this host (cache-miss-bound
// pointer chasing); these block the binary search 16 queries wide and
// prefetch every lane's next probe, hiding the misses (~4-6x), and run
// the query range on 2 threads.  A linear-merge variant covers sorted
// query streams at O(n+m) sequential bandwidth.  This is the host-side
// counterpart of the graph's rank primitive (src/SparseArray.hh:278-334
// accessAndRank) that every cleanup/threading pass leans on.
// ---------------------------------------------------------------------------

extern "C" {

static void rank_range_u64(const uint64_t* a, long n, const uint64_t* q,
                           long m, int64_t* out) {
    constexpr int B = 16;
    long rounds = 0;
    while ((1L << rounds) <= n) ++rounds;
    long i = 0;
    for (; i + B <= m; i += B) {
        long lo[B], hi[B], mid[B];
        for (int j = 0; j < B; ++j) { lo[j] = 0; hi[j] = n; }
        for (long r = 0; r < rounds; ++r) {
            for (int j = 0; j < B; ++j) {
                mid[j] = (lo[j] + hi[j]) >> 1;
                __builtin_prefetch(a + (mid[j] < n ? mid[j] : n - 1));
            }
            for (int j = 0; j < B; ++j) {
                if (lo[j] >= hi[j]) continue;
                long k = mid[j] < n - 1 ? mid[j] : n - 1;
                if (a[k] < q[i + j]) lo[j] = mid[j] + 1; else hi[j] = mid[j];
            }
        }
        for (int j = 0; j < B; ++j) out[i + j] = lo[j];
    }
    for (; i < m; ++i) {
        long lo1 = 0, sz = n;
        while (sz > 0) {
            long half = sz >> 1;
            if (a[lo1 + half] < q[i]) { lo1 += half + 1; sz -= half + 1; }
            else sz = half;
        }
        out[i] = lo1;
    }
}

void gossio_rank_u64(const uint64_t* a, long n, const uint64_t* q, long m,
                     int64_t* out, int threads) {
    if (n <= 0) { for (long i = 0; i < m; ++i) out[i] = 0; return; }
    if (threads > 1 && m >= (1L << 16)) {
        long half = m / 2;
        std::thread th(rank_range_u64, a, n, q, half, out);
        rank_range_u64(a, n, q + half, m - half, out + half);
        th.join();
    } else {
        rank_range_u64(a, n, q, m, out);
    }
}

// queries sorted ascending: one linear merge pass
void gossio_merge_rank_u64(const uint64_t* a, long n, const uint64_t* q,
                           long m, int64_t* out) {
    long i = 0;
    for (long j = 0; j < m; ++j) {
        while (i < n && a[i] < q[j]) ++i;
        out[j] = i;
    }
}
}

// ---------------------------------------------------------------------------
// Host kmerize: 255-separated 2-bit code stream -> rolling rho-mer u64
// keys + validity.  The numpy shift-or loop costs rho passes over the
// window array (~10s per 60M windows at rho 26 on this host); this is
// one sequential pass.  Narrow keys only (2*rho <= 64).
// ---------------------------------------------------------------------------

extern "C" {

void gossio_kmerize_u64(const uint8_t* codes, long n_codes, int rho,
                        uint64_t* lo, uint8_t* valid) {
    const long n_win = n_codes - rho + 1;
    if (n_win <= 0) return;
    const uint64_t mask =
        (2 * rho == 64) ? ~0ULL : ((1ULL << (2 * rho)) - 1);
    uint64_t v = 0;
    long run = 0;  // consecutive valid codes ending at i
    for (long i = 0; i < n_codes; ++i) {
        uint8_t b = codes[i];
        if (b < 4) { v = ((v << 2) | b) & mask; ++run; }
        else { v = 0; run = 0; }
        long w = i - rho + 1;
        if (w >= 0) {
            lo[w] = v;
            valid[w] = run >= rho;
        }
    }
}

// Sequential chain decomposition over the successor table: for each
// edge, its chain head and position, chains laid out contiguously in
// ascending-head order.  The vectorized pointer-doubling formulation
// (graph/segments.py) is the device shape; on the host a direct O(n) walk
// is ~10x less work.  Returns the number of non-cyclic edges (cycle
// edges get start = -1).
long gossio_chains(const int64_t* nxt, long n,
                   int64_t* start, int64_t* pos, int64_t* order) {
    std::vector<uint8_t> has_prev(n, 0);
    for (long i = 0; i < n; ++i)
        if (nxt[i] >= 0) has_prev[nxt[i]] = 1;
    for (long i = 0; i < n; ++i) start[i] = -1;
    long o = 0;
    for (long h = 0; h < n; ++h) {
        if (has_prev[h]) continue;  // not a chain head
        long p = 0;
        long e = h;
        while (e >= 0 && start[e] < 0) {
            start[e] = h;
            pos[e] = p++;
            order[o++] = e;
            e = nxt[e];
        }
    }
    return o;
}
}

// ---------------------------------------------------------------------------
// Fused successor table for narrow (2*rho <= 64) symmetric graphs:
// for each edge i, the rank of the unique next edge in its linear
// segment, or -1 when to(i) is not a 1-in/1-out node
// (graph/graph.py successor_table; reference linearPath walks,
// src/Graph.tcc:21-46).  One pass builds the four query streams, the
// prefetching rank kernel resolves them, one pass combines — the
// separate numpy formulation paid ~7 full-array passes of overhead on
// top of the searches.
// ---------------------------------------------------------------------------

extern "C" {

static inline uint64_t rev2_u64(uint64_t x) {
    x = __builtin_bswap64(x);
    x = ((x & 0x3333333333333333ULL) << 2) |
        ((x >> 2) & 0x3333333333333333ULL);
    x = ((x & 0x0F0F0F0F0F0F0F0FULL) << 4) |
        ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL);
    return x;
}

void gossio_successor_table_u64(const uint64_t* lo, long n, int rho,
                                int64_t* nxt, int threads) {
    const int k = rho - 1;
    const uint64_t node_mask =
        (2 * k == 64) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    const int rc_sh = 64 - 2 * k;
    std::vector<uint64_t> q(4 * (size_t)n);
    uint64_t* b0 = q.data();
    uint64_t* b1 = b0 + n;
    uint64_t* r0q = b1 + n;
    uint64_t* r1q = r0q + n;
    for (long i = 0; i < n; ++i) {
        uint64_t t = lo[i] & node_mask;
        uint64_t b = t << 2;
        uint64_t rt = rev2_u64(~t) >> rc_sh;
        uint64_t rb = rt << 2;
        b0[i] = b;
        b1[i] = b + 4;  // wrap only possible when 2*rho == 64 (handled below)
        r0q[i] = rb;
        r1q[i] = rb + 4;
    }
    std::vector<int64_t> r(4 * (size_t)n);
    gossio_rank_u64(lo, n, b0, n, r.data(), threads);
    gossio_rank_u64(lo, n, b1, n, r.data() + n, threads);
    gossio_rank_u64(lo, n, r0q, n, r.data() + 2 * n, threads);
    gossio_rank_u64(lo, n, r1q, n, r.data() + 3 * n, threads);
    const bool may_wrap = (2 * rho == 64);
    for (long i = 0; i < n; ++i) {
        int64_t e0 = r[i], e1 = r[n + i];
        int64_t i0 = r[2 * n + i], i1 = r[3 * n + i];
        if (may_wrap) {
            if (b1[i] == 0) e1 = n;
            if (r1q[i] == 0) i1 = n;
        }
        nxt[i] = (e1 - e0 == 1 && i1 - i0 == 1) ? e0 : -1;
    }
}
}

// Read-aligned block API: pop one producer block verbatim (always ends
// at a read boundary, ~4MB).  For consumers that need whole reads per
// batch (thread-reads link extraction) rather than the fixed-size
// window stream.  Returns the block length, 0 at end of stream, or
// -needed when cap is too small (caller retries with a larger buffer).
extern "C" long gossio_next_block(gossio_stream* s, uint8_t* buf, long cap) {
    if (s->pending_off < s->pending.size()) {
        long n = (long)(s->pending.size() - s->pending_off);
        if (n > cap) return -n;
        memcpy(buf, s->pending.data() + s->pending_off, n);
        s->pending.clear();
        s->pending_off = 0;
        return n;
    }
    if (s->eof) return 0;
    std::vector<uint8_t> blk = s->producer->pop();
    if (blk.empty()) {
        s->eof = true;
        return 0;
    }
    long n = (long)blk.size();
    if (n > cap) {
        s->pending = std::move(blk);
        s->pending_off = 0;
        return -n;
    }
    memcpy(buf, blk.data(), n);
    return n;
}

// Fused (out_degree, in_degree) of NODE keys against the sorted narrow
// edge array: out = rank(n<<2+4) - rank(n<<2), in = the same over
// rc(n) (symmetric graph; GraphEssentials.hh:74-77).  One query-build
// pass + four prefetching rank calls + one combine.
extern "C" void gossio_node_degrees_u64(const uint64_t* lo, long n, int rho,
                                        const uint64_t* nodes, long m,
                                        int64_t* out_deg, int64_t* in_deg,
                                        int threads) {
    const int k = rho - 1;
    const int rc_sh = 64 - 2 * k;
    std::vector<uint64_t> q(4 * (size_t)m);
    uint64_t* b0 = q.data();
    uint64_t* b1 = b0 + m;
    uint64_t* r0q = b1 + m;
    uint64_t* r1q = r0q + m;
    for (long i = 0; i < m; ++i) {
        uint64_t t = nodes[i];
        uint64_t rt = rev2_u64(~t) >> rc_sh;
        b0[i] = t << 2;
        b1[i] = (t << 2) + 4;
        r0q[i] = rt << 2;
        r1q[i] = (rt << 2) + 4;
    }
    std::vector<int64_t> r(4 * (size_t)m);
    gossio_rank_u64(lo, n, b0, m, r.data(), threads);
    gossio_rank_u64(lo, n, b1, m, r.data() + m, threads);
    gossio_rank_u64(lo, n, r0q, m, r.data() + 2 * m, threads);
    gossio_rank_u64(lo, n, r1q, m, r.data() + 3 * m, threads);
    const bool may_wrap = (2 * rho == 64);
    for (long i = 0; i < m; ++i) {
        int64_t e1 = r[m + i], i1 = r[3 * m + i];
        if (may_wrap) {
            if (b1[i] == 0) e1 = n;
            if (r1q[i] == 0) i1 = n;
        }
        out_deg[i] = e1 - r[i];
        in_deg[i] = i1 - r[2 * m + i];
    }
}

// Expansion ORDER of a canonical spectrum: same merge as
// gossio_expand_symmetric, but counts are not needed — out_src[i] is
// the INPUT index supplying output lane i and out_dbl[i] flags
// palindromes (count doubles on apply).  Lets the engine compute the
// order in a background thread from the early-pull snapshot KEYS while
// the device still streams batches; the finish tail is then just
// out_c = where(dbl, 2*c[src], c[src]) (ops/engine.py:_prex_work).
extern "C" long gossio_expand_order(long n, const uint64_t* lo, int rho,
                                    uint64_t* out_lo, int64_t* out_src,
                                    uint8_t* out_dbl) {
    uint8_t lut[256];
    for (int b = 0; b < 256; ++b) {
        int r = ((b & 0x33) << 2) | ((b >> 2) & 0x33);
        lut[b] = (uint8_t)(((r & 0x0F) << 4) | ((r >> 4) & 0x0F));
    }
    const int shift = 64 - 2 * rho;
    const int kb = 2 * rho;
    const uint64_t half_bit = 1ULL << (kb - 1);
    std::vector<uint8_t> pal(n, 0);
    std::vector<ExpRec> buck[2][2];  // [thread][top-bit]; c = src index
    {
        auto scan = [&](int t, long lo_i, long hi_i) {
            buck[t][0].reserve((hi_i - lo_i) / 2 + 16);
            buck[t][1].reserve((hi_i - lo_i) / 2 + 16);
            for (long i = lo_i; i < hi_i; ++i) {
                uint64_t r = rev2c_u64(lo[i], lut) >> shift;
                if (r == lo[i]) pal[i] = 1;
                else buck[t][r >= half_bit].push_back({r, i});
            }
        };
        std::thread th(scan, 0, 0L, n / 2);
        scan(1, n / 2, n);
        th.join();
    }
    std::vector<ExpRec> rc0, rc1;
    rc0.reserve(buck[0][0].size() + buck[1][0].size());
    rc1.reserve(buck[0][1].size() + buck[1][1].size());
    for (int t = 0; t < 2; ++t) {
        rc0.insert(rc0.end(), buck[t][0].begin(), buck[t][0].end());
        rc1.insert(rc1.end(), buck[t][1].begin(), buck[t][1].end());
        buck[t][0].clear(); buck[t][0].shrink_to_fit();
        buck[t][1].clear(); buck[t][1].shrink_to_fit();
    }
    {
        std::thread th([&] { radix_sort_recs(rc0, kb - 1); });
        radix_sort_recs(rc1, kb - 1);
        th.join();
    }
    long i = 0, o = 0;
    auto merge_run = [&](const std::vector<ExpRec>& rc) {
        long j = 0;
        const long m = (long)rc.size();
        while (i < n && j < m) {
            if (lo[i] < rc[j].k) {
                out_lo[o] = lo[i]; out_src[o] = i; out_dbl[o] = pal[i]; ++i;
            } else {
                out_lo[o] = rc[j].k; out_src[o] = rc[j].c; out_dbl[o] = 0;
                ++j;
            }
            ++o;
        }
        for (; j < m; ++j, ++o) {
            out_lo[o] = rc[j].k; out_src[o] = rc[j].c; out_dbl[o] = 0;
        }
    };
    merge_run(rc0);
    merge_run(rc1);
    for (; i < n; ++i, ++o) {
        out_lo[o] = lo[i]; out_src[o] = i; out_dbl[o] = pal[i];
    }
    return o;
}

// Apply counts through a precomputed expansion order:
// out_c[i] = (dbl[i] ? 2 : 1) * c[src[i]].  numpy fancy indexing runs
// ~5M elem/s on small-vCPU hosts (measured); this loop is memory-bound.
extern "C" void gossio_apply_order(long m, const int64_t* src,
                                   const uint8_t* dbl, const int64_t* c,
                                   int64_t* out_c) {
    long h = m / 2;
    std::thread th([&] {
        for (long i = 0; i < h; ++i)
            out_c[i] = c[src[i]] << (dbl[i] ? 1 : 0);
    });
    for (long i = h; i < m; ++i)
        out_c[i] = c[src[i]] << (dbl[i] ? 1 : 0);
    th.join();
}

// Split finish-time counts (aligned with merge(snapshot_keys, new_keys))
// back into snapshot-aligned and new-key-aligned planes in one pass.
// idx[j] (sorted, insertion positions of new keys into the snapshot)
// puts new key j at merged lane idx[j] + j.  numpy's bincount/cumsum/
// fancy-index formulation measured ~0.9s per 4.6M keys on this host.
extern "C" void gossio_split_counts(long n1, long n_new,
                                    const int64_t* idx, const int64_t* c,
                                    int64_t* out_snap, int64_t* out_new) {
    long j = 0, s = 0;
    const long n = n1 + n_new;
    for (long i = 0; i < n; ++i) {
        if (j < n_new && i == idx[j] + j) out_new[j++] = c[i];
        else out_snap[s++] = c[i];
    }
}

// Merge a large sorted spectrum with a small sorted addition in one
// pass (keys must be disjoint).  Replaces two np.insert copies
// (~0.9s per 9.2M keys on this host).
extern "C" void gossio_insert_merge(long n, long m,
                                    const uint64_t* base_lo,
                                    const int64_t* base_c,
                                    const uint64_t* add_lo,
                                    const int64_t* add_c,
                                    uint64_t* out_lo, int64_t* out_c) {
    // m << n: binary-search insertion points, then two threads memcpy
    // disjoint halves of the output (the host's effective single-core
    // copy bandwidth measured ~150MB/s; the output is ~150MB)
    auto lower = [&](long from, uint64_t key) {
        long lo_i = from, hi = n;
        while (lo_i < hi) {
            long mid = (lo_i + hi) >> 1;
            if (base_lo[mid] < key) lo_i = mid + 1; else hi = mid;
        }
        return lo_i;
    };
    long jm = m / 2;
    long im = jm < m ? lower(0, add_lo[jm]) : n;
    auto run = [&](long j0, long j1, long i0, long i_end) {
        long i = i0, o = i0 + j0;
        for (long j = j0; j < j1; ++j) {
            long p = lower(i, add_lo[j]);
            long seg = p - i;
            if (seg) {
                memcpy(out_lo + o, base_lo + i, seg * sizeof(uint64_t));
                memcpy(out_c + o, base_c + i, seg * sizeof(int64_t));
                i = p; o += seg;
            }
            out_lo[o] = add_lo[j]; out_c[o] = add_c[j]; ++o;
        }
        if (i < i_end) {
            memcpy(out_lo + o, base_lo + i, (i_end - i) * sizeof(uint64_t));
            memcpy(out_c + o, base_c + i, (i_end - i) * sizeof(int64_t));
        }
    };
    std::thread th([&] { run(0, jm, 0, im); });
    run(jm, m, im, n);
    th.join();
}
