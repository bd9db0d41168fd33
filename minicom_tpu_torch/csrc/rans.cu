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
// differs. Encode takes the per-slot frequency f and cumulative c already
// gathered on the host, as the JAX context program does. Decode takes the
// block headers as they lie in a stream (u16 frequency rows, states, words
// per lane, the lane streams) and builds its own tables.
//
// State machine (32-bit state in [2^16, 2^32), 16-bit renormalisation,
// M = 2^12): all arithmetic is uint32_t, so decode's f * (x >> 12) + slot - c
// wraps mod 2^32 exactly as the JAX program does. The emit test is written
// (x >> 20) >= f: x >= f << 20 overflows at f = M (a one-symbol block).
//
// Layout: one block of 128 threads per rANS block, one thread per lane; a
// [T, 128] grid is row-major with the lane fastest, so each step's loads and
// stores are coalesced across the block. The format fixes 128 lanes (the
// header stores log2 of the lane count), so a block cannot widen without
// changing bytes. Bound: both scans are serial chains of T dependent steps
// per lane; the kernels are bound by the latency of one step times T, not
// by bytes. Encode (a u32 division per step) software-pipelines its loads:
// the next tile of kTile steps is in flight while the current one is coded.
//
// Decode is designed around that chain:
//   * one launch decodes every rANS block of a stream: grid = blocks, each
//     CUDA block reads its own descriptor row, so a stream takes the time of
//     its longest block and the other SMs are not idle while it runs;
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
constexpr int kTile = 16;
constexpr uint32_t kMBits = 12;
constexpr uint32_t kM = 1u << kMBits;
constexpr uint32_t kRansL = 1u << 16;
constexpr int kMaxSmem = 232448;   // dynamic shared memory of a Hopper block

// steps base-1 .. base-kTile (reverse time) of lane l; t < 0 is a pad step
__device__ __forceinline__ void load_tile(const uint32_t* __restrict__ f,
                                          const uint32_t* __restrict__ c,
                                          const uint8_t* __restrict__ valid,
                                          int64_t base, int l,
                                          uint32_t (&tf)[kTile],
                                          uint32_t (&tc)[kTile],
                                          uint32_t (&tv)[kTile]) {
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
        const int64_t t = base - 1 - j;
        if (t >= 0) {
            const int64_t i = t * kLanes + l;
            tf[j] = __ldg(f + i);
            tc[j] = __ldg(c + i);
            tv[j] = __ldg(valid + i);
        } else {
            tf[j] = 1;
            tc[j] = 0;
            tv[j] = 0;
        }
    }
}

// f, c: [T, 128] u32; valid: [T, 128] u8 (0/1). Out: states [128] u32, words
// [T, 128] u16 (lane l's words in forward time order in rows 0..counts[l]-1,
// zeros below), counts [128] i32.
__global__ void __launch_bounds__(kLanes)
rans_encode_kernel(const uint32_t* __restrict__ f,
                   const uint32_t* __restrict__ c,
                   const uint8_t* __restrict__ valid, int64_t T,
                   uint32_t* __restrict__ states, uint16_t* __restrict__ words,
                   int32_t* __restrict__ counts) {
    const int l = threadIdx.x;
    uint32_t x = kRansL;
    int64_t n = 0;
    uint32_t af[kTile], ac[kTile], av[kTile];
    uint32_t bf[kTile], bc[kTile], bv[kTile];
    load_tile(f, c, valid, T, l, af, ac, av);
    for (int64_t base = T; base > 0; base -= kTile) {
        if (base > kTile) load_tile(f, c, valid, base - kTile, l, bf, bc, bv);
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
            if (!av[j]) continue;   // pad step: the state passes through
            const uint32_t fj = af[j] > 1u ? af[j] : 1u;
            if ((x >> 20) >= fj) {
                // the reverse scan emits last-first: word e goes to row
                // T-1-e, so rows T-n .. T-1 end up in forward order
                words[(T - 1 - n) * kLanes + l] = (uint16_t)(x & 0xFFFFu);
                ++n;
                x >>= 16;
            }
            x = ((x / fj) << kMBits) | ((x % fj) + ac[j]);
        }
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
            af[j] = bf[j];
            ac[j] = bc[j];
            av[j] = bv[j];
        }
    }
    states[l] = x;
    counts[l] = (int32_t)n;
    // move rows T-n .. T-1 up to 0 .. n-1 (source row >= destination row,
    // so a forward in-place copy is safe) and zero the rest of the column
#pragma unroll 8
    for (int64_t i = 0; i < T; ++i)
        words[i * kLanes + l] =
            i < n ? words[(T - n + i) * kLanes + l] : (uint16_t)0;
}

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

}  // namespace

extern "C" {

int mtc_rans_encode(const uint32_t* f, const uint32_t* c,
                    const uint8_t* valid, int64_t T, uint32_t* states,
                    uint16_t* words, int32_t* counts, void* stream) {
    rans_encode_kernel<<<1, kLanes, 0, (cudaStream_t)stream>>>(
        f, c, valid, T, states, words, counts);
    return (int)cudaGetLastError();
}

// What ops/rans.py must agree with, for it to check when it loads the
// library: the fields of a descriptor row, the most dynamic shared memory a
// launch may ask for, the bytes before the cumulative rows, the words of a
// granule.
void mtc_rans_layout(int64_t* out) {
    out[0] = kDescFields;
    out[1] = kMaxSmem;
    out[2] = kFixed;
    out[3] = kGran;
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
