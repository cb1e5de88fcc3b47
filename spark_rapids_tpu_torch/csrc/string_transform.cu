// K15 — substring of a byte matrix, K18 — row-wise concatenation, and
// K20 — trim and substring_index.
//
// Replaces spark_rapids_tpu/ops/kernels/stringkernels.py:substring (93),
// which ops/stringexprs.py:Substring (156-197) runs: for each row of
// (uint8[n, w] bytes, int32[n] lengths), with a 0-based start (negative:
// from the end) and a byte count, the row's bytes [s, e) go to an out_w
// wide row, zero past e - s (the zero bytes later K8 and K1 passes read),
// and e - s to the new lengths.  The row arithmetic is strings.cuh's
// str_substring, which K12 inlines when a Substring sits in a fused
// segment.
//
// Bound on this card: bytes.  Each row reads its length and at most out_w
// bytes of its row, and writes out_w bytes and a length: at Q22's
// customer table (262,144 padded rows, c_phone 15 bytes wide, out_w 2)
// at most (4 + 15) + (2 + 4) bytes a row, ~6.6 MB, ~2 us at 3.35 TB/s,
// far below a launch.  Design: one thread per output byte, grid-strided,
// so neighbouring threads write neighbouring bytes and read neighbouring
// bytes of a row; when out_w is at most 4 one thread writes a whole row
// (a thread per byte would recompute the row's bounds out_w times for
// one or two bytes).  No shared memory, no fallback.
//
// K18 replaces spark_rapids_tpu/ops/kernels/stringkernels.py:concat (113),
// which ops/stringexprs.py:ConcatStrings (362-393) runs: k parts (uint8
// [n, w_i] bytes, int32[n] lengths; a one-row literal is read with a row
// stride of 0) become one uint8[n, sum of w_i] matrix, each row the parts'
// bytes [0, len_i) at the running length, then zeros, and the sum of the
// lengths.  A part byte at or past its width repeats the last column, and
// nothing is written at or past the output width, as the reference's
// clipped take_along_axis does.  Bound on this card: bytes.  For the
// TPC-H lineitem export line (23 parts, a 148-byte output row) at
// 8,388,608 padded rows the function reads ~100 bytes of parts and 92 of
// lengths and writes 152 bytes a row: ~2.9 GB, ~0.86 ms at 3.35 TB/s.
// Design: as K15, one thread per output byte (neighbouring threads write
// neighbouring bytes), each walking the parts' lengths of its row to find
// its part; one thread per row when the output is at most 4 bytes wide.
// The parts' pointers, widths and strides travel in the launch
// parameters (at most MAX_PARTS; the wrapper concatenates more in
// groups).
//
// K20 replaces spark_rapids_tpu/ops/kernels/stringkernels.py:trim_ws
// (279) and substring_index (216), which ops/stringexprs.py's StringTrim,
// StringTrimLeft, StringTrimRight and SubstringIndex run: each row keeps
// a span of its bytes, [s, s + new length), copied to the front of an
// out_w wide row, zeros after.  trim drops leading and/or trailing
// spaces (0x20 only); substring_index with a one-byte delimiter keeps
// the bytes before the count-th delimiter (count > 0) or after the
// |count|-th from the right (count < 0; too few delimiters keep the row,
// count 0 keeps nothing).  The spans are strings.cuh's str_trim_ws and
// str_substring_index, which K12 reads in place as it reads a substring.
// Bound on this card: bytes, as K15: each row reads its length and its
// bytes and writes out_w bytes and a length: the orders preview (24
// bytes, 2,097,152 padded rows) ~0.17 GB read and written, ~50 us at
// 3.35 TB/s.  Design: two launches, one thread a row finding its span
// (a serial scan of the row, strided reads as K13's) into a scratch of
// starts and the new lengths, then K15's copy, one thread an output byte
// (coalesced writes).
#include "strings.cuh"

namespace {

using srt::BLOCK;

constexpr unsigned MAX_BLOCKS = 65535;

// one thread per output byte
__global__ void substring_bytes(const uint8_t* __restrict__ bm,
                                const int* __restrict__ lengths, int w,
                                long long n, int start, int sub_len,
                                int out_w, uint8_t* __restrict__ out,
                                int* __restrict__ out_len) {
  const long long total = n * (long long)out_w;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / out_w;
    const int q = (int)(i - row * out_w);
    int s;
    const int nl = srt::str_substring(lengths[row], start, sub_len, &s);
    out[i] = q < nl ? bm[row * (long long)w + s + q] : (uint8_t)0;
    if (q == 0) out_len[row] = nl;
  }
}

// one thread per row (out_w <= 4)
__global__ void substring_rows(const uint8_t* __restrict__ bm,
                               const int* __restrict__ lengths, int w,
                               long long n, int start, int sub_len,
                               int out_w, uint8_t* __restrict__ out,
                               int* __restrict__ out_len) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += stride) {
    int s;
    const int nl = srt::str_substring(lengths[row], start, sub_len, &s);
    const uint8_t* src = bm + row * (long long)w + s;
    uint8_t* dst = out + row * (long long)out_w;
    for (int q = 0; q < out_w; ++q) dst[q] = q < nl ? src[q] : (uint8_t)0;
    out_len[row] = nl;
  }
}

// one thread per output byte: the span [starts[row], + out_len[row])
__global__ void span_bytes(const uint8_t* __restrict__ bm, int w,
                           long long n, const int* __restrict__ starts,
                           const int* __restrict__ out_len, int out_w,
                           uint8_t* __restrict__ out) {
  const long long total = n * (long long)out_w;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / out_w;
    const int q = (int)(i - row * out_w);
    out[i] = q < out_len[row] ? bm[row * (long long)w + starts[row] + q]
                              : (uint8_t)0;
  }
}

// one thread per row: the span of trim (mode 0, a = left, b = right) or
// substring_index (mode 1, a = delimiter, b = count)
__global__ void span_rows(const uint8_t* __restrict__ bm,
                          const int* __restrict__ lengths, int w,
                          long long n, int mode, int a, int b,
                          int* __restrict__ starts,
                          int* __restrict__ out_len) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += stride) {
    const uint8_t* r = bm + row * (long long)w;
    int s;
    const int nl = mode == 0
        ? srt::str_trim_ws(r, w, lengths[row], a != 0, b != 0, &s)
        : srt::str_substring_index(r, w, lengths[row], a, b, &s);
    starts[row] = s;
    out_len[row] = nl;
  }
}

unsigned grid_for(long long items) {
  const long long b = (items + BLOCK - 1) / BLOCK;
  return (unsigned)(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

constexpr int MAX_PARTS = 64;

struct Parts {
  const uint8_t* bm[MAX_PARTS];
  const int* len[MAX_PARTS];
  int w[MAX_PARTS];
  int rs[MAX_PARTS];  // row stride: 1, or 0 for a one-row literal
  int k;
};

// byte q of a row of the concatenation (0 past the parts' lengths); the
// row's total length when `total` is given
__device__ __forceinline__ uint8_t concat_byte(const Parts& p, long long row,
                                               int q, int* total) {
  int off = 0;
  uint8_t b = 0;
  bool found = false;
  for (int i = 0; i < p.k; ++i) {
    const long long r = p.rs[i] ? row : 0;
    const int ln = p.len[i][r];
    if (!found && q >= off && q < off + ln) {
      const int c = q - off;
      b = p.bm[i][r * (long long)p.w[i] + (c < p.w[i] ? c : p.w[i] - 1)];
      found = true;
      if (total == nullptr) return b;
    }
    off += ln;
  }
  if (total != nullptr) *total = off;
  return b;
}

// one thread per output byte
__global__ void concat_bytes(const Parts p, long long n, int out_w,
                             uint8_t* __restrict__ out,
                             int* __restrict__ out_len) {
  const long long total = n * (long long)out_w;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long row = i / out_w;
    const int q = (int)(i - row * out_w);
    int len;
    out[i] = concat_byte(p, row, q, q == 0 ? &len : nullptr);
    if (q == 0) out_len[row] = len;
  }
}

// one thread per row (out_w <= 4)
__global__ void concat_rows(const Parts p, long long n, int out_w,
                            uint8_t* __restrict__ out,
                            int* __restrict__ out_len) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n; row += stride) {
    int len;
    for (int q = 0; q < out_w; ++q)
      out[row * (long long)out_w + q] =
          concat_byte(p, row, q, q == 0 ? &len : nullptr);
    out_len[row] = len;
  }
}

}  // namespace

// start: 0-based (negative counts from the end), sub_len >= 0 bytes,
// out_w >= 1 columns of out; out_len gets the new lengths
SRT_API int k15_substring(const void* bm, const void* lengths, int w,
                          long long n, int start, int sub_len, int out_w,
                          void* out, void* out_len, void* stream) {
  if (out_w < 1 || w < 1) return (int)cudaErrorInvalidValue;
  if (out_w <= 4)
    substring_rows<<<grid_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)bm, (const int*)lengths, w, n, start, sub_len,
        out_w, (uint8_t*)out, (int*)out_len);
  else
    substring_bytes<<<grid_for(n * (long long)out_w), BLOCK, 0,
                      (cudaStream_t)stream>>>(
        (const uint8_t*)bm, (const int*)lengths, w, n, start, sub_len,
        out_w, (uint8_t*)out, (int*)out_len);
  return (int)cudaGetLastError();
}

// k parts: bms[i] uint8[n or 1, widths[i]], lens[i] int32[n or 1] (row
// stride strides[i], 1 or 0) -> out uint8[n, out_w], out_len int32[n]
SRT_API int k18_concat(const void* const* bms, const void* const* lens,
                       const int* widths, const int* strides, int k,
                       long long n, int out_w, void* out, void* out_len,
                       void* stream) {
  if (k < 1 || k > MAX_PARTS || out_w < 1) return (int)cudaErrorInvalidValue;
  Parts p;
  p.k = k;
  for (int i = 0; i < k; ++i) {
    if (widths[i] < 1) return (int)cudaErrorInvalidValue;
    p.bm[i] = (const uint8_t*)bms[i];
    p.len[i] = (const int*)lens[i];
    p.w[i] = widths[i];
    p.rs[i] = strides[i];
  }
  if (out_w <= 4)
    concat_rows<<<grid_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
        p, n, out_w, (uint8_t*)out, (int*)out_len);
  else
    concat_bytes<<<grid_for(n * (long long)out_w), BLOCK, 0,
                   (cudaStream_t)stream>>>(p, n, out_w, (uint8_t*)out,
                                           (int*)out_len);
  return (int)cudaGetLastError();
}

namespace {

int k20_span(const void* bm, const void* lengths, int w, long long n,
             int mode, int a, int b, int out_w, void* starts, void* out,
             void* out_len, void* stream) {
  if (w < 1 || out_w < 1) return (int)cudaErrorInvalidValue;
  span_rows<<<grid_for(n), BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bm, (const int*)lengths, w, n, mode, a, b,
      (int*)starts, (int*)out_len);
  span_bytes<<<grid_for(n * (long long)out_w), BLOCK, 0,
               (cudaStream_t)stream>>>(
      (const uint8_t*)bm, w, n, (const int*)starts, (const int*)out_len,
      out_w, (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// trim: left/right 0 or 1; starts int32[n] scratch, out uint8[n, out_w],
// out_len int32[n]
SRT_API int k20_trim(const void* bm, const void* lengths, int w, long long n,
                     int left, int right, int out_w, void* starts, void* out,
                     void* out_len, void* stream) {
  return k20_span(bm, lengths, w, n, 0, left, right, out_w, starts, out,
                  out_len, stream);
}

// substring_index: delim a byte (0..255), count in [-w - 1, w + 1]
SRT_API int k20_substring_index(const void* bm, const void* lengths, int w,
                                long long n, int delim, int count, int out_w,
                                void* starts, void* out, void* out_len,
                                void* stream) {
  if (delim < 0 || delim > 255) return (int)cudaErrorInvalidValue;
  return k20_span(bm, lengths, w, n, 1, delim, count, out_w, starts, out,
                  out_len, stream);
}
