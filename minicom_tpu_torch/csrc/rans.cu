// Interleaved 128-lane rANS for Hopper (sm_90a), bound with ctypes from
// minicom_tpu_torch/ops/rans.py. Plain C interface: device pointers and a
// cudaStream_t in, a cudaError_t out, no allocation, no synchronisation.
//
// Replaces the XLA device programs of both on-device entropy codecs:
//   * minicom_tpu/entropy/device_rans.py     _encode_program / _decode_program
//     (codec "trans": order-0, lane l owns symbols l, l+128, ...),
//   * minicom_tpu/entropy/device_ctx_rans.py _encode_program / _decode_program
//     (codecs "trans1", "trans2" and the residual coder of "dzt": order-k
//     contexts over an alphabet of A symbols, lane l owns a contiguous chunk).
// Order-0 is the context coder with C = 1 context and A = 256, so one encode
// and one decode kernel serve both; only the lane layout (strided or chunked)
// differs. Both take a stream as it lies in memory: encode the symbol ids
// (u8) and each block's u16 frequency rows, decode the block headers (u16
// frequency rows, states, words per lane, the lane streams); both build
// their own tables in shared memory, and one launch handles every rANS
// block of a stream: grid = blocks, each CUDA block reads its own descriptor
// row, so a stream takes the time of its longest block.
//
// State machine (32-bit state in [2^16, 2^32), 16-bit renormalisation,
// M = 2^12): all arithmetic is uint32_t, so decode's f * (x >> 12) + slot - c
// wraps mod 2^32 exactly as the JAX program does. The emit test is written
// (x >> 20) >= f: x >= f << 20 overflows at f = M (a one-symbol block).
//
// Layout: one block of 128 threads per rANS block, one thread per lane. The
// format fixes 128 lanes (the header stores log2 of the lane count), so a
// block cannot widen without changing bytes. Bound: both scans are serial
// chains of T dependent steps per lane, and one warp per scheduler hides no
// latency: the kernels are bound by the latency of one step times T, not by
// bytes. So whatever does not depend on the state is taken off the chain.
//
// Encode is designed around that chain:
//   * nothing per slot comes from the host: a lane reads its symbols 16 at a
//     time (one 16-byte load of its chunk and 4 bytes for the symbols before
//     it, or 16 coalesced byte loads of a strided lane, packed only when
//     they are needed), two granules ahead of the scan, and finds each
//     slot's validity from n and the lane layout (a lane's valid steps are a
//     prefix), its context from the four symbols before it (weights A^(i-1)
//     for i <= k, else 0), and its f and c from a table staged in shared
//     memory at block start: one entry f | c << 16 per (context, symbol)
//     where 4 bytes an entry fit, else cumulative rows of u16 (at most 128
//     KB);
//   * no division on the chain: q = xr / f is the high half of xr * (m + 1)
//     with m = floor((2^64 - 1) / f) read from a table of the 4096 possible
//     f in shared memory, taken as two 32 x 32 -> 64 bit multiply-adds
//     (p0 = xr * m.lo + xr, p1 = xr * m.hi + (p0 >> 32), q = p1 >> 32; no
//     sum passes 2^64). m + 1 = ceil(2^64 / f) = (2^64 + e) / f with
//     0 <= e < f, so xr * (m + 1) / 2^64 = (xr + xr * e / 2^64) / f, and
//     xr * e < 2^64 keeps the floor at xr / f: exact for every u32 xr and f.
//     The remainder is xr - q * f, folded with + c into one multiply-add;
//   * no load on the chain: a slot's f, c and reciprocal are in registers a
//     granule before the state reaches it, prepared slot by slot between
//     the steps of the granule before (one warp per scheduler overlaps only
//     what lies side by side in the code it runs);
//   * a pad slot is the slot f = M, c = 0, which leaves every state as it
//     is and never emits, so a step has no validity test;
//   * the reverse scan emits a lane's last word first, so lane l writes its
//     words downwards from the end of its part of a scratch buffer (a block
//     emits at most one word per valid slot); then the block sums the 128
//     counts in shared memory and its warps copy each lane's words to where
//     the header wants them: forward order, lanes concatenated.
//
// Decode is designed around that chain:
//   * no table in device memory on the chain: at block start the 128 threads
//     turn the header's u16 frequency rows into cumulative rows in shared
//     memory (C rows of pow2 >= A u16; at most 209,952 bytes for any (A, k)
//     the format allows, A = 9 and k = 4, of the 232,448 a Hopper block may
//     opt in to) and, where
//     C * 4096 bytes fit beside them, into a slot -> symbol table there too;
//     otherwise a step finds its symbol in its row: rows of up to 16 entries
//     are read whole and compared two entries an instruction, longer rows
//     by binary search (log2 A shared loads). f is cum[s] - cum[s - 1];
//   * no division on the chain: ctx' = (ctx * A + s) mod C is a multiply by
//     ceil(2^32 / C) and a shift, exact for ctx * A + s < 2^16;
//   * no load from device memory on the chain: each lane reads its word
//     stream where it lies in the blob, 16 bytes at a time and kGran steps
//     ahead of need, through a ring in shared memory (see kGran below), and
//     keeps its next word in a register; the valid steps of a lane are a
//     prefix whose length follows from n and the lane layout.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr uint32_t kMBits = 12;
constexpr uint32_t kM = 1u << kMBits;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kMaxSmem = 232448;   // dynamic shared memory of a Hopper block

// Descriptor row of one rANS block (int64 fields; offsets in elements of
// their buffer). ops/rans.py builds and checks the rows on the host.
enum Desc {
    kWordsOff,   // first u16 of the block's lane streams in `words`
    kNWords,     // u16 words of the block (sum of its lanes' counts)
    kFreqOff,    // first u16 of the block's [C, A] frequency rows in `freq`
    kOutOff,     // first byte of the block's [T, 128] grid in `syms`
    kN,          // symbols coded in the block
    kT,          // steps
    kW,          // height of the word matrix the reference would read
    kA,          // alphabet size
    kC,          // contexts
    kChunked,    // 1: lane l owns symbols [l*T, (l+1)*T); 0: l, l+128, ...
    kUseLut,     // 1: slot -> symbol table in shared memory
    kDescFields
};

// Cumulative rows in shared memory: row r holds P = pow2 >= max(A, 2) u16
// entries, e[j] = freq[0] + ... + freq[j] (so e[j] is one past symbol j's
// last slot), then kPad up to P. The symbol of a slot is the count of
// entries <= slot; zero-frequency symbols repeat a value and are stepped
// over. kFlag marks what no slot may count: every entry of an unused row
// (sum 0: symbol 0, f = 0, c = 0, as its zero tables gave) and the last
// entry of every row (so the count stays below A whatever the row holds).
// The value of an entry is its low 14 bits.
constexpr uint32_t kFlag = 0x4000u;
constexpr uint32_t kPad = 0x7FFFu;
constexpr uint32_t kVal = 0x3FFFu;

enum Mode { kModeLut, kModeSwar, kModeBin };

// count of entries <= slot in a row of P (a power of two) sorted entries,
// by binary lifting: log2 P dependent shared loads
__device__ __forceinline__ uint32_t find_bin(const uint16_t* row, uint32_t P,
                                             uint32_t slot) {
    uint32_t lo = 0;
    for (uint32_t step = P >> 1; step > 0; step >>= 1)
        if ((uint32_t)row[lo + step - 1] <= slot) lo += step;
    return lo;
}

// the same count for a row of kP <= 16 entries read whole (one or two wide
// loads) and compared two at a time: with every entry below 2^15, bit 15 of
// each half of (0x8000 + slot) - entry is set where entry <= slot
template <int kP>
__device__ __forceinline__ uint32_t find_swar(const uint16_t* row,
                                              uint32_t slot) {
    const uint32_t key = slot | (slot << 16) | 0x80008000u;
    constexpr uint32_t kOnes = 0x00010001u;
    uint32_t acc = 0;
    if (kP == 2) {
        acc = ((key - *reinterpret_cast<const uint32_t*>(row)) >> 15) & kOnes;
    } else if (kP == 4) {
        const uint2 w = *reinterpret_cast<const uint2*>(row);
        acc = (((key - w.x) >> 15) & kOnes) + (((key - w.y) >> 15) & kOnes);
    } else {
#pragma unroll
        for (int i = 0; i < kP / 8; ++i) {
            const uint4 w = reinterpret_cast<const uint4*>(row)[i];
            acc += (((key - w.x) >> 15) & kOnes) + (((key - w.y) >> 15) & kOnes)
                   + (((key - w.z) >> 15) & kOnes)
                   + (((key - w.w) >> 15) & kOnes);
        }
    }
    return (acc & 0xFFFFu) + (acc >> 16);
}

// Words reach a lane through a ring in shared memory, kRing granules of
// kGran words (16 bytes) per lane, so that no step waits for device memory.
// Every kGran steps each lane stores the granule it asked for kGran steps
// earlier and asks for the next one while it is at most 3 granules ahead: a
// lane takes at most one word a step, so the words of the next kGran steps
// (at most 2 granules ahead) are always in the ring.
constexpr uint32_t kGran = 8;
constexpr uint32_t kRing = 4;
// dynamic shared memory before the cumulative rows: the lanes' word counts,
// then the ring
constexpr int kFixed = kLanes * 4 + kRing * kLanes * 16;

// granule g of `words` (16-byte aligned base); the buffer's last granule may
// be partial and is read word by word
__device__ __forceinline__ uint4 load_granule(const uint16_t* words,
                                              int64_t g, int64_t words_len) {
    if ((g + 1) * kGran <= words_len)
        return __ldg(reinterpret_cast<const uint4*>(words) + g);
    uint32_t v[4] = {0, 0, 0, 0};
    for (uint32_t j = 0; j < kGran; ++j) {
        const int64_t i = g * kGran + j;
        if (i < words_len) v[j >> 1] |= (uint32_t)words[i] << (16 * (j & 1));
    }
    return make_uint4(v[0], v[1], v[2], v[3]);
}

// What a block's lanes share, set up before the scan.
struct Model {
    const uint16_t* cum;    // shared: C rows of 1 << lgP entries
    const uint8_t* lut;     // shared: C * 4096 symbols (kModeLut)
    uint32_t lgP, A, C;
    uint32_t T, W;
    const uint16_t* words;  // device: the batch's words
    int64_t words_len;
    uint4* ring;            // shared: kRing * 128 granules
};

// The scan of one lane: T steps from state x, written to out[t * 128]. kMode
// is how a step finds its symbol (the slot table, a whole-row compare for
// kP <= 16 entries, or binary search); the lane's first nv steps are valid.
// One warp per scheduler hides no latency, so every instruction of a step
// counts: indices are 32-bit (the wrapper keeps every buffer below 2^31
// elements), a step has no branch (the refill is a select), and the steps
// run in groups of kGran with the ring's top-up between them.
template <int kMode, int kP>
__device__ __forceinline__ void scan_lane(
        const Model& m, uint32_t x, uint32_t nv, uint8_t* out, uint32_t q0,
        uint32_t cnt, int l) {
    const uint32_t lgP = m.lgP, A = m.A, C = m.C, W1 = m.W - 1;
    // ctx' = v - (v / C) * C with v / C = umulhi(v, ceil(2^32 / C)), v < 2^16
    const uint32_t inv = C > 1 ? (uint32_t)(((1ull << 32) + C - 1) / C) : 0u;
    const uint32_t ctx_mask = C > 1 ? ~0u : 0u;
    // word p of the lane (p < cnt) lies in granule (q0 + p) / kGran, which
    // the ring keeps in slot granule % kRing of this lane
    const uint16_t* ring16 =
        reinterpret_cast<const uint16_t*>(m.ring) + l * kGran;
    auto ring_word = [&](uint32_t p) -> uint32_t {
        const uint32_t q = q0 + p;
        return ring16[((q / kGran) % kRing) * (kLanes * kGran) + q % kGran];
    };
    const uint32_t end = q0 + cnt;      // one past the lane's last word
    const uint32_t last = m.W < cnt ? W1 : cnt - 1;   // last word it reads
    uint32_t g_next = q0 / kGran;       // the next granule to ask for
    for (uint32_t j = 0; j < kRing - 1; ++j, ++g_next)
        if (g_next * kGran < end)
            m.ring[(g_next % kRing) * kLanes + l] =
                load_granule(m.words, g_next, m.words_len);
    uint4 pending = make_uint4(0, 0, 0, 0);
    bool has_pending = false;
    uint32_t ptr = 0, ctx = 0;
    // the word the reference reads at words[min(ptr, W-1)] of this lane: its
    // matrix holds zeros below a lane's last word
    uint32_t next = cnt > 0 ? ring_word(0) : 0u;

    auto top_up = [&]() {
        if (has_pending)
            m.ring[((g_next - 1) % kRing) * kLanes + l] = pending;
        const uint32_t p0 = ptr < last ? ptr : last;
        has_pending = cnt > 0 && g_next <= (q0 + p0) / kGran + kRing - 1
                      && g_next * kGran < end;
        if (has_pending)
            pending = load_granule(m.words, g_next++, m.words_len);
    };
    auto symbol = [&](const uint16_t* row, uint32_t slot) -> uint32_t {
        if (kMode == kModeLut) return m.lut[(ctx << kMBits) + slot];
        if (kMode == kModeSwar) return find_swar<kP>(row, slot);
        return find_bin(row, 1u << lgP, slot);
    };
    auto step = [&]() {
        const uint32_t slot = x & (kM - 1);
        const uint16_t* row = m.cum + (ctx << lgP);
        const uint32_t s = symbol(row, slot);
        *out = (uint8_t)s;
        out += kLanes;
        const uint32_t hi = row[s] & kVal;
        const uint32_t c = row[s - (s != 0)] & (s ? kVal : 0u);
        uint32_t xn = (hi - c) * (x >> kMBits) + slot - c;
        const bool need = xn < kRansL;
        ctx = ((ctx * A + s) - __umulhi(ctx * A + s, inv) * C) & ctx_mask;
        x = need ? (xn << 16) | next : xn;
        ptr += need;
        const uint32_t p = ptr < W1 ? ptr : W1;
        const uint32_t w = ring_word(p);
        next = p < cnt ? w : 0u;
    };

    uint32_t t = 0;
    for (; t + kGran <= nv; t += kGran) {
        top_up();
#pragma unroll
        for (uint32_t j = 0; j < kGran; ++j) step();
    }
    top_up();
    for (; t < nv; ++t) step();
    // the lane's pad steps: state and context stand still, so one symbol
    if (t < m.T) {
        const uint8_t pad =
            (uint8_t)symbol(m.cum + (ctx << lgP), x & (kM - 1));
        for (; t < m.T; ++t, out += kLanes) *out = pad;
    }
}

// head [B, 256] u32: each block's lane states, then its words per lane;
// words [words_len]: the blocks' lane streams, each lane's words in read
// order, lanes in order; freq: the blocks' [C, A] u16 frequency rows; desc
// [B, kDescFields]. Out: syms, each block's [T, 128] u8 grid (every step,
// pad steps included, as the JAX program gives them). Dynamic shared
// memory: 128 u32, the word ring, the cumulative rows, the slot table.
// One block per SM in the launch bounds: without it ptxas economises
// registers for an occupancy that one warp per scheduler cannot use, and
// orders a step's instructions in fewer of them: 44 registers against 55,
// and 102 against 82 ns a step on an order-0 block of an H100.
__global__ void __launch_bounds__(kLanes, 1)
rans_decode_kernel(const uint32_t* __restrict__ head,
                   const uint16_t* __restrict__ words, int64_t words_len,
                   const uint16_t* __restrict__ freq,
                   const int64_t* __restrict__ desc,
                   uint8_t* __restrict__ syms) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int l = threadIdx.x;
    const int64_t* d = desc + (int64_t)blockIdx.x * kDescFields;
    const int64_t n = d[kN], nwords = d[kNWords];
    const uint32_t T = (uint32_t)d[kT];
    const uint32_t A = (uint32_t)d[kA], C = (uint32_t)d[kC];
    uint32_t lgP = 1;           // rows of P = pow2 >= max(A, 2) entries
    while ((1u << lgP) < A) ++lgP;
    const uint32_t P = 1u << lgP;
    const bool use_lut = d[kUseLut] != 0;
    uint32_t* lane_cnt = reinterpret_cast<uint32_t*>(smem);
    uint4* ring = reinterpret_cast<uint4*>(smem + kLanes * 4);
    uint16_t* cum = reinterpret_cast<uint16_t*>(smem + kFixed);
    // rows end on a 16-byte boundary so the slot table starts on one
    uint8_t* lut = smem + kFixed + (((size_t)C * P * 2 + 15) & ~(size_t)15);

    // stage the model: cumulative rows (thread per row), then the slot table
    const uint16_t* fq = freq + d[kFreqOff];
    for (uint32_t r = l; r < C; r += kLanes) {
        const uint16_t* fr = fq + (size_t)r * A;
        uint16_t* cr = cum + ((size_t)r << lgP);
        uint32_t acc = 0;
        for (uint32_t s = 0; s < A; ++s) {
            acc += __ldg(fr + s);
            cr[s] = (uint16_t)(acc < kVal ? acc : kVal);
        }
        cr[A - 1] |= (uint16_t)kFlag;
        if (acc == 0)
            for (uint32_t s = 0; s < A; ++s) cr[s] = (uint16_t)kFlag;
        for (uint32_t s = A; s < P; ++s) cr[s] = (uint16_t)kPad;
    }
    const uint32_t own = head[(int64_t)blockIdx.x * 2 * kLanes + kLanes + l];
    lane_cnt[l] = own;
    __syncthreads();
    if (use_lut)
        for (uint32_t i = l; i < C * kM; i += kLanes)
            lut[i] = (uint8_t)find_bin(cum + ((size_t)(i >> kMBits) << lgP),
                                       P, i & (kM - 1));
    // this lane's words: [start, start + cnt) of the block's, kept inside it
    int64_t start = 0;
    for (int j = 0; j < l; ++j) start += lane_cnt[j];
    if (start > nwords) start = nwords;
    const uint32_t cnt =
        (uint32_t)(own < nwords - start ? (int64_t)own : nwords - start);
    const uint32_t q0 = (uint32_t)(d[kWordsOff] + start);
    __syncthreads();

    // the valid steps of the lane: a prefix of length nv
    int64_t nv;
    if (d[kChunked]) {
        nv = n - (int64_t)l * T;
        nv = nv < 0 ? 0 : nv;
    } else {
        nv = n > l ? (n - l + kLanes - 1) / kLanes : 0;
    }
    const uint32_t nvu = (uint32_t)(nv > T ? T : nv);
    const uint32_t x = head[(int64_t)blockIdx.x * 2 * kLanes + l];
    uint8_t* out = syms + d[kOutOff] + l;
    const Model m = {cum, lut, lgP, A, C, T, (uint32_t)d[kW], words,
                     words_len, ring};
    if (use_lut) scan_lane<kModeLut, 0>(m, x, nvu, out, q0, cnt, l);
    else if (P == 2) scan_lane<kModeSwar, 2>(m, x, nvu, out, q0, cnt, l);
    else if (P == 4) scan_lane<kModeSwar, 4>(m, x, nvu, out, q0, cnt, l);
    else if (P == 8) scan_lane<kModeSwar, 8>(m, x, nvu, out, q0, cnt, l);
    else if (P == 16) scan_lane<kModeSwar, 16>(m, x, nvu, out, q0, cnt, l);
    else scan_lane<kModeBin, 0>(m, x, nvu, out, q0, cnt, l);
}

// ---- encode ---------------------------------------------------------------

// Descriptor row of one rANS block to encode (int64 fields; offsets in
// elements of their buffer). ops/rans.py builds and checks the rows.
enum EncDesc {
    kESyms,      // first byte of the block's n symbol ids in `syms`
    kEFreq,      // first u16 of the block's [C, A] frequency rows in `freq`
    kEWords,     // first u16 of the block's part (n words) of `scratch` and
                 // of `words`
    kEN,         // symbols in the block
    kET,         // steps
    kEA,         // alphabet size
    kEC,         // contexts, A^k
    kEChunked,   // 1: lane l owns symbols [l*T, (l+1)*T); 0: l, l+128, ...
    kEK,         // order k <= 4 (0 where C = 1)
    kEPacked,    // 1: the slot table f | c << 16 in shared memory (4 bytes
                 // an entry); 0: cumulative rows (2 bytes an entry)
    kEncFields
};

constexpr uint32_t kSlots = 16;      // slots of a granule: one 16-byte load
constexpr uint32_t kCopy = 16;       // words a thread copies at a time
// dynamic shared memory before the block's table: the lanes' word counts,
// their offsets in the block's stream, the reciprocal of every f in 1..M
constexpr int kEncFixed = 2 * kLanes * 4 + kM * 8;
// a pad slot: f = M, c = 0 (c in the high half)
constexpr uint32_t kPadSlot = kM;

// the valid steps of lane l (a prefix of its T) and the valid slots of the
// lanes before it, which is where its part of the scratch buffer starts
__device__ __forceinline__ void lane_span(uint32_t n, uint32_t T, bool chunked,
                                          uint32_t l, uint32_t& nv,
                                          uint32_t& before) {
    if (chunked) {
        before = l * T < n ? l * T : n;
        nv = n - before < T ? n - before : T;
    } else {
        const uint32_t q = n / kLanes, r = n % kLanes;
        before = l * q + (l < r ? l : r);
        nv = q + (l < r);
    }
}

// A granule of a lane in flight: symbols 16g .. 16g+15, step 16g+j in byte j
// of `sym` once `settle` has run, and in `before` the four symbols before
// them (symbol 0 before the lane's first). Steps at or past nv, and every
// step of g < 0, read as symbol 0. A chunked lane's symbols lie side by side
// from p: one 16-byte load, and a 4-byte load for `before`. A strided
// lane's lie 128 bytes apart: 16 byte loads, kept apart in `raw` until
// `settle` packs them, so that the loads are not waited for where they are
// issued (a strided lane has no context, so no `before`).
template <bool kChunked>
struct Granule {
    uint32_t sym[4];
    uint32_t before;
    uint32_t raw[kChunked ? 1 : kSlots];

    __device__ __forceinline__ void fetch(const uint8_t* p, int32_t g,
                                          uint32_t nv) {
        sym[0] = sym[1] = sym[2] = sym[3] = before = 0;
#pragma unroll
        for (uint32_t j = 0; j < (kChunked ? 1 : kSlots); ++j) raw[j] = 0;
        if (g < 0) return;
        const uint32_t t0 = (uint32_t)g * kSlots;
        if (!kChunked) {
#pragma unroll
            for (uint32_t j = 0; j < kSlots; ++j)
                if (t0 + j < nv) raw[j] = __ldg(p + (size_t)(t0 + j) * kLanes);
            return;
        }
        const bool aligned = (reinterpret_cast<uintptr_t>(p) & 15) == 0;
        if (aligned && t0 + kSlots <= nv) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + t0));
            sym[0] = v.x; sym[1] = v.y; sym[2] = v.z; sym[3] = v.w;
        } else {
#pragma unroll
            for (uint32_t j = 0; j < kSlots; ++j)
                if (t0 + j < nv)
                    sym[j >> 2] |= (uint32_t)__ldg(p + t0 + j)
                                   << (8 * (j & 3));
        }
        if (g == 0) return;
        if (aligned) {
            before = __ldg(reinterpret_cast<const uint32_t*>(p + t0 - 4));
        } else {
#pragma unroll
            for (uint32_t j = 0; j < 4; ++j)
                before |= (uint32_t)__ldg(p + t0 - 4 + j) << (8 * j);
        }
    }

    __device__ __forceinline__ void settle() {
        if (kChunked) return;
#pragma unroll
        for (uint32_t j = 0; j < kSlots; ++j)
            sym[j >> 2] |= raw[j] << (8 * (j & 3));
    }
};

// What a block's lanes share while they encode. The table of a block is
// one of two: where C * A * 4 bytes fit, an entry f | c << 16 for every
// (context, symbol), so a slot costs one load; else C rows of A inclusive
// cumulative sums, from which a slot takes two entries (the format's largest
// tables, 65,536 entries, fit in shared memory only so).
struct EncModel {
    const uint32_t* fct;   // shared: f | c << 16 at [ctx * A + s], or
    const uint16_t* cum;   // shared: freq[0] + ... + freq[s] there
    const uint2* rcp;      // shared: floor((2^64 - 1) / f) at [f - 1]
    uint32_t A;
    uint32_t w[4];         // context weights: A^(i-1) for i <= k, else 0
};

// The slots of a granule, ready to code: f | c << 16, and the two halves of
// f's reciprocal.
struct Slots {
    uint32_t fc[kSlots], mlo[kSlots], mhi[kSlots];
};

// Slot j of a settled granule, `count` of whose slots are valid; the
// context of a slot of a chunked lane is the k <= 4 symbols before it,
// oldest in the highest digit (a strided lane has none); the reciprocal
// comes with it, so that a step loads nothing. Nothing here depends on the
// coder's state.
template <bool kChunked, bool kPacked>
__device__ __forceinline__ void prepare_slot(const EncModel& m,
                                             const Granule<kChunked>& gr,
                                             int j, uint32_t count,
                                             Slots& out) {
    auto sym = [&](int i) -> uint32_t {     // symbol of step i, i >= -4
        const uint32_t word = i < 0 ? gr.before : gr.sym[i >> 2];
        return (word >> (8 * (i & 3))) & 0xFFu;
    };
    const uint32_t s = sym(j);
    uint32_t ctx = 0;
    if (kChunked) {
#pragma unroll
        for (int i = 1; i <= 4; ++i) ctx += sym(j - i) * m.w[i - 1];
    }
    uint32_t fc;
    if (kPacked) {
        fc = m.fct[ctx * m.A + s];
    } else {
        const uint16_t* row = m.cum + ctx * m.A;
        const uint32_t hi = row[s];
        const uint32_t lo = row[s - (s != 0)];
        const uint32_t c = s ? lo : 0u;
        // sums wrap at 2^16 like the u16 they are kept in, so f is the
        // symbol's own frequency whatever the row sums to
        const uint32_t f = (hi - c) & 0xFFFFu;
        fc = (f > 1u ? f : 1u) | (c << 16);
    }
    if ((uint32_t)j >= count) fc = kPadSlot;
    out.fc[j] = fc;
    const uint2 r = m.rcp[(fc & 0xFFFFu) - 1];
    out.mlo[j] = r.x;
    out.mhi[j] = r.y;
}

// Step j of a granule on the state x; an emitted word goes to scr[--pos].
__device__ __forceinline__ void code_slot(const Slots& in, int j, uint32_t& x,
                                          uint16_t* scr, uint32_t& pos) {
    const uint32_t f = in.fc[j] & 0xFFFFu, c = in.fc[j] >> 16;
    // (x >> 20) >= f as one compare: x > (f << 20) - 1, which wraps to
    // 2^32 - 1 at f = M, where no state emits
    const bool emit = x > (f << 20) - 1u;
    // the word in a register of its own: the store holds its operand for a
    // while, and the state is written again at once
    uint32_t word;
    asm("mov.b32 %0, %1;" : "=r"(word) : "r"(x));
    if (emit) scr[--pos] = (uint16_t)word;
    const uint32_t xr = emit ? x >> 16 : x;
    const uint64_t p0 = (uint64_t)xr * in.mlo[j] + xr;
    const uint64_t p1 = (uint64_t)xr * in.mhi[j] + (p0 >> 32);
    const uint32_t q = (uint32_t)(p1 >> 32);
    x = (q << kMBits) | (xr + c - q * f);
}

// The scan of one lane over its nv valid steps, last step first. The words
// go downwards from scr[nv], so they end up in forward order from scr[pos]
// on. Returns the final state; `pos` comes back at the lane's first word.
template <bool kChunked, bool kPacked>
__device__ __forceinline__ uint32_t encode_lane(const EncModel& m,
                                                const uint8_t* p, uint32_t nv,
                                                uint16_t* scr,
                                                uint32_t& pos) {
    uint32_t x = kRansL;
    pos = nv;
    const int32_t G = (int32_t)((nv + kSlots - 1) / kSlots);
    if (G == 0) return x;
    // a turn codes granule g from `cur` while it prepares granule g-1 into
    // `nxt` from the settled granule `near`, slot by slot between the steps
    // (one warp per scheduler overlaps only what lies side by side in the
    // code it runs), and fetches granule g-2 into `far`; the two
    // granules and the two sets of slots swap roles from turn to turn
    Granule<kChunked> ga, gb;
    Slots sa, sb;
    auto turn = [&](int32_t g, const Slots& cur, Slots& nxt,
                    Granule<kChunked>& near, Granule<kChunked>& far) {
        far.fetch(p, g - 2, nv);
#pragma unroll
        for (int j = (int)kSlots - 1; j >= 0; --j) {
            prepare_slot<kChunked, kPacked>(m, near, j, kSlots, nxt);
            code_slot(cur, j, x, scr, pos);
        }
        far.settle();
    };
    int32_t g = G - 1;
    ga.fetch(p, g, nv);
    ga.settle();
#pragma unroll
    for (int j = 0; j < (int)kSlots; ++j)
        prepare_slot<kChunked, kPacked>(m, ga, j, nv - (uint32_t)g * kSlots,
                                        sa);
    ga.fetch(p, g - 1, nv);
    ga.settle();
    if (G & 1) {        // an odd turn first, then turns in pairs
        turn(g, sa, sb, ga, gb);
        --g;
        sa = sb;
        ga = gb;
    }
    for (; g >= 1; g -= 2) {
        turn(g, sa, sb, ga, gb);
        turn(g - 1, sb, sa, gb, ga);
    }
    return x;
}

// syms: the blocks' symbol ids; freq: their [C, A] u16 frequency rows, no
// entry above M; desc [B, kEncFields]. Out: head [B, 256] u32, each block's
// lane states, then its words per lane; words: at each block's offset its
// lane streams, each lane's words in decode read order, lanes in order;
// scratch: as large as words. Dynamic shared memory: kEncFixed bytes, then
// the block's table. One block per SM in the launch bounds, as for decode.
__global__ void __launch_bounds__(kLanes, 1)
rans_encode_kernel(const uint8_t* __restrict__ syms,
                   const uint16_t* __restrict__ freq,
                   const int64_t* __restrict__ desc,
                   uint32_t* __restrict__ head, uint16_t* __restrict__ scratch,
                   uint16_t* __restrict__ words) {
    extern __shared__ __align__(16) uint8_t smem[];
    const uint32_t l = threadIdx.x;
    const int64_t* d = desc + (int64_t)blockIdx.x * kEncFields;
    const uint32_t n = (uint32_t)d[kEN], T = (uint32_t)d[kET];
    const uint32_t A = (uint32_t)d[kEA], C = (uint32_t)d[kEC];
    const bool chunked = d[kEChunked] != 0;
    uint32_t* lane_cnt = reinterpret_cast<uint32_t*>(smem);
    uint32_t* lane_off = lane_cnt + kLanes;
    uint2* rcp = reinterpret_cast<uint2*>(smem + 2 * kLanes * 4);
    uint16_t* cum = reinterpret_cast<uint16_t*>(smem + kEncFixed);

    // stage the model: the reciprocals, then the block's table (a thread
    // per row; sums wrap at 2^16 in both forms)
    for (uint32_t i = l; i < kM; i += kLanes) {
        const uint64_t m = ~0ull / (uint64_t)(i + 1);
        rcp[i] = make_uint2((uint32_t)m, (uint32_t)(m >> 32));
    }
    const uint16_t* fq = freq + d[kEFreq];
    const bool packed = d[kEPacked] != 0;
    uint32_t* fct = reinterpret_cast<uint32_t*>(smem + kEncFixed);
    for (uint32_t r = l; r < C; r += kLanes) {
        const uint16_t* fr = fq + (size_t)r * A;
        uint16_t* cr = cum + (size_t)r * A;
        uint32_t* pr = fct + (size_t)r * A;
        uint32_t acc = 0;
        for (uint32_t s = 0; s < A; ++s) {
            const uint32_t f = __ldg(fr + s);
            if (packed) pr[s] = (f > 1u ? f : 1u) | (acc << 16);
            acc += f;
            if (!packed) cr[s] = (uint16_t)acc;
        }
    }
    __syncthreads();

    EncModel m = {fct, cum, rcp, A, {0, 0, 0, 0}};
    uint32_t wi = 1;
#pragma unroll
    for (uint32_t i = 0; i < 4; ++i, wi *= A)
        m.w[i] = i < (uint32_t)d[kEK] ? wi : 0u;
    uint32_t nv, before;
    lane_span(n, T, chunked, l, nv, before);
    uint16_t* scr = scratch + d[kEWords] + before;
    // keep the pointer in registers: rebuilt from the kernel's arguments at
    // every store, it would cost a step a load from the constant bank
    asm volatile("" : "+l"(scr));
    uint32_t pos;
    const uint8_t* sy = syms + d[kESyms];
    const uint8_t* ch = sy + (size_t)l * T;
    uint32_t x;
    // a strided lane has no context, and every table it can have (A <= 256
    // entries) is a packed one
    if (!chunked) x = encode_lane<false, true>(m, sy + l, nv, scr, pos);
    else if (packed) x = encode_lane<true, true>(m, ch, nv, scr, pos);
    else x = encode_lane<true, false>(m, ch, nv, scr, pos);
    const uint32_t cnt = nv - pos;
    uint32_t* hd = head + (size_t)blockIdx.x * 2 * kLanes;
    hd[l] = x;
    hd[kLanes + l] = cnt;
    lane_cnt[l] = cnt;
    __syncthreads();     // also: every lane's scratch words are written
    uint32_t off = 0;
    for (uint32_t j = 0; j < l; ++j) off += lane_cnt[j];
    lane_off[l] = off;
    __syncthreads();

    // lane j's words: from below the end of its part of scratch to their
    // place in the block's stream; a warp per lane, lanes in turns
    uint16_t* out = words + d[kEWords];
    for (uint32_t j = l / 32; j < kLanes; j += kLanes / 32) {
        uint32_t nvj, bj;
        lane_span(n, T, chunked, j, nvj, bj);
        const uint32_t cj = lane_cnt[j];
        const uint16_t* src = scratch + d[kEWords] + bj + nvj - cj;
        uint16_t* dst = out + lane_off[j];
        // kCopy loads in flight a thread, then their stores
        for (uint32_t i0 = l % 32; i0 < cj; i0 += 32 * kCopy) {
            uint16_t v[kCopy];
#pragma unroll
            for (uint32_t u = 0; u < kCopy; ++u)
                if (i0 + 32 * u < cj) v[u] = src[i0 + 32 * u];
#pragma unroll
            for (uint32_t u = 0; u < kCopy; ++u)
                if (i0 + 32 * u < cj) dst[i0 + 32 * u] = v[u];
        }
    }
}

}  // namespace

extern "C" {

// One launch for the B blocks of desc, with the shared memory opt-in of
// mtc_rans_decode below.
int mtc_rans_encode(const uint8_t* syms, const uint16_t* freq,
                    const int64_t* desc, int64_t B, int64_t smem_bytes,
                    uint32_t* head, uint16_t* scratch, uint16_t* words,
                    void* stream) {
    cudaError_t err = cudaFuncSetAttribute(
        rans_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    rans_encode_kernel<<<(unsigned)B, kLanes, (size_t)smem_bytes,
                         (cudaStream_t)stream>>>(syms, freq, desc, head,
                                                 scratch, words);
    return (int)cudaGetLastError();
}

// What ops/rans.py must agree with, for it to check when it loads the
// library: the fields of a decode descriptor row, the most dynamic shared
// memory a launch may ask for, decode's bytes before the cumulative rows, the
// words of a granule, the fields of an encode descriptor row, encode's bytes
// before a block's table.
void mtc_rans_layout(int64_t* out) {
    out[0] = kDescFields;
    out[1] = kMaxSmem;
    out[2] = kFixed;
    out[3] = kGran;
    out[4] = kEncFields;
    out[5] = kEncFixed;
}

// One launch for the B blocks of desc; smem_bytes is the largest block's
// need (ops/rans.py computes it and keeps it within kMaxSmem).
int mtc_rans_decode(const uint32_t* head, const uint16_t* words,
                    int64_t words_len, const uint16_t* freq,
                    const int64_t* desc, int64_t B, int64_t smem_bytes,
                    uint8_t* syms, void* stream) {
    // above 48 KB dynamic shared memory is an opt-in per function; the same
    // value every time, so concurrent callers cannot undercut each other
    cudaError_t err = cudaFuncSetAttribute(
        rans_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    rans_decode_kernel<<<(unsigned)B, kLanes, (size_t)smem_bytes,
                         (cudaStream_t)stream>>>(head, words, words_len,
                                                 freq, desc, syms);
    return (int)cudaGetLastError();
}

}  // extern "C"
