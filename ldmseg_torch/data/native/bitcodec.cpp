// Native analog-bits codec + LUT remap: the host data path's hot loops
// (the port's copy of ldmseg_tpu/data/native/bitcodec.cpp).
//
// The threaded loader spends its per-sample time in PNG decode (libpng via
// PIL) and the analog-bits encode / id-remap passes. The latter two are
// pure memory-bound loops, implemented here so a sample's label pipeline
// is one C pass instead of several numpy temporaries. Bound with ctypes
// (ldmseg_torch/data/native/__init__.py) and compiled at first use with
// g++ -O3 into ldmseg_torch/_build/; the numpy codec (ops/bits.py) is the
// plain version the tests hold it against.

#include <cstdint>
#include <cstring>

extern "C" {

// ids [n] int32 -> bits [n, nbits] float32 (channels-last innermost).
// Pixels equal to ignore_label are filled with fill_value in every plane;
// pass ignore_label < 0 to disable. Returns 0 on success.
int encode_bits_i32(const int32_t* ids, int64_t n, int nbits,
                    int32_t ignore_label, float fill_value, float* out) {
    if (nbits <= 0 || nbits > 31) return 1;
    for (int64_t i = 0; i < n; ++i) {
        const int32_t v = ids[i];
        float* dst = out + i * nbits;
        if (ignore_label >= 0 && v == ignore_label) {
            for (int b = 0; b < nbits; ++b) dst[b] = fill_value;
        } else {
            uint32_t u = static_cast<uint32_t>(v);
            for (int b = 0; b < nbits; ++b) dst[b] = (u >> b) & 1u;
        }
    }
    return 0;
}

// bit planes [n, nbits] float32 (values in ~[-1, 1], set bit when > 0)
// -> ids [n] int32; the all-ones code maps to 0 when invalid_to_zero.
int decode_bits_i32(const float* bits, int64_t n, int nbits,
                    int invalid_to_zero, int32_t* out) {
    if (nbits <= 0 || nbits > 31) return 1;
    const int32_t all_ones = (1 << nbits) - 1;
    for (int64_t i = 0; i < n; ++i) {
        const float* src = bits + i * nbits;
        int32_t v = 0;
        for (int b = 0; b < nbits; ++b)
            v |= (src[b] > 0.0f) ? (1 << b) : 0;
        if (invalid_to_zero && v == all_ones) v = 0;
        out[i] = v;
    }
    return 0;
}

// Apply an id lookup table: out[i] = lut[ids[i]] (ids must be < lut_len;
// out-of-range ids map to fallback). One pass replaces the per-unique-id
// boolean-mask loops of the reference remap (kitti.py:350-358).
int remap_lut_i32(const int32_t* ids, int64_t n, const int32_t* lut,
                  int64_t lut_len, int32_t fallback, int32_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const int32_t v = ids[i];
        out[i] = (v >= 0 && v < lut_len) ? lut[v] : fallback;
    }
    return 0;
}

}  // extern "C"
