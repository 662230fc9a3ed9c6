// Native runtime codec for peritext-tpu change logs (the PyTorch port's copy
// of native/peritext_native.cpp; the two encode the same bytes).
//
// The reference keeps changes as JSON and cites Automerge's binary change
// format as the real-world encoding (micromerge.ts:496-497).  This is the
// framework's native equivalent: a columnar zigzag+LEB128 varint codec with
// per-column delta encoding, used for change-log shipping and durable
// storage (peritext_tpu_torch/runtime/native_codec.py binds it via ctypes).
//
// Layout contract (shared with the Python binding):
//   encode_columns(data[n_cols * n_rows], ...) — data is column-major;
//   each column is delta-encoded (first value raw), zigzag-mapped, then
//   LEB128 varint-packed.  Column boundaries are implicit: the decoder
//   knows (n_cols, n_rows).
//
// Build: peritext_tpu_torch/ops/_build.py compiles it with g++ at first use
// into peritext_tpu_torch/build/native_codec-<hash>.so.

#include <cstdint>
#include <cstddef>

namespace {

inline uint32_t zigzag(int32_t v) {
    return (static_cast<uint32_t>(v) << 1) ^ static_cast<uint32_t>(v >> 31);
}

inline int32_t unzigzag(uint32_t v) {
    return static_cast<int32_t>((v >> 1) ^ (~(v & 1) + 1));
}

inline size_t put_varint(uint32_t v, uint8_t* out) {
    size_t n = 0;
    while (v >= 0x80) {
        out[n++] = static_cast<uint8_t>(v) | 0x80;
        v >>= 7;
    }
    out[n++] = static_cast<uint8_t>(v);
    return n;
}

inline size_t get_varint(const uint8_t* in, size_t len, uint32_t* v) {
    uint32_t result = 0;
    int shift = 0;
    size_t n = 0;
    while (n < len && shift < 35) {
        uint8_t b = in[n++];
        result |= static_cast<uint32_t>(b & 0x7f) << shift;
        if (!(b & 0x80)) {
            *v = result;
            return n;
        }
        shift += 7;
    }
    return 0;  // malformed
}

}  // namespace

extern "C" {

// Worst-case output size for sizing buffers: 5 bytes per value.
size_t pt_encode_bound(size_t n_values) { return n_values * 5; }

// Encode column-major int32 data. Returns bytes written, or 0 if out_cap is
// too small.
size_t pt_encode_columns(const int32_t* data, size_t n_cols, size_t n_rows,
                         uint8_t* out, size_t out_cap) {
    size_t pos = 0;
    for (size_t c = 0; c < n_cols; ++c) {
        const int32_t* col = data + c * n_rows;
        int32_t prev = 0;
        for (size_t r = 0; r < n_rows; ++r) {
            int64_t delta = static_cast<int64_t>(col[r]) - prev;
            prev = col[r];
            if (pos + 5 > out_cap) return 0;
            pos += put_varint(zigzag(static_cast<int32_t>(delta)), out + pos);
        }
    }
    return pos;
}

// Decode into column-major int32 data. Returns values written
// (n_cols * n_rows), or 0 on malformed/overflow input.
size_t pt_decode_columns(const uint8_t* in, size_t len, size_t n_cols,
                         size_t n_rows, int32_t* out, size_t out_cap) {
    if (out_cap < n_cols * n_rows) return 0;
    size_t pos = 0;
    for (size_t c = 0; c < n_cols; ++c) {
        uint32_t prev = 0;  // modular accumulation — signed overflow is UB
        for (size_t r = 0; r < n_rows; ++r) {
            uint32_t raw;
            size_t used = get_varint(in + pos, len - pos, &raw);
            if (used == 0) return 0;
            pos += used;
            prev += static_cast<uint32_t>(unzigzag(raw));
            out[c * n_rows + r] = static_cast<int32_t>(prev);
        }
    }
    return (pos == len) ? n_cols * n_rows : 0;
}

}  // extern "C"
