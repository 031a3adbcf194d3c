// The port's one-pass FASTQ parse: each complete record of a buffer goes
// straight into its row of the (rows x width) block being filled, so the
// ingest writes a block once and allocates nothing per chunk.
//
// A host library with a plain C interface for ctypes, built by the C++
// compiler (io/native.py), apart from the CUDA kernels.

#include <cstdint>
#include <cstring>

namespace {

// base code table: A/a=0 C/c=1 G/g=2 T/t=3, everything else (incl N) = 4
struct CodeTable {
  uint8_t t[256];
  CodeTable() {
    memset(t, 4, sizeof(t));
    t[(unsigned)'A'] = t[(unsigned)'a'] = 0;
    t[(unsigned)'C'] = t[(unsigned)'c'] = 1;
    t[(unsigned)'G'] = t[(unsigned)'g'] = 2;
    t[(unsigned)'T'] = t[(unsigned)'t'] = 3;
  }
};
const CodeTable CODE;

inline const char* find_nl(const char* p, const char* end) {
  const void* q = memchr(p, '\n', end - p);
  return q ? (const char*)q : end;
}

// CODE.t on 32 bytes at once: |0x20 folds case, ((x >> 1) ^ (x >> 2)) & 3
// maps a/c/g/t to 0/1/2/3, and every other byte becomes 4.
typedef uint8_t u8x32 __attribute__((vector_size(32)));

inline u8x32 codes32(u8x32 c) {
  u8x32 x = c | 0x20;
  u8x32 code = ((x >> 1) ^ (x >> 2)) & 3;
  u8x32 ok = (u8x32)((x == 'a') | (x == 'c') | (x == 'g') | (x == 't'));
  return (code & ok) | (~ok & 4);
}

inline void to_codes(const char* s, uint8_t* o, int64_t n) {
  if (n < 32) {
    for (int64_t i = 0; i < n; ++i) o[i] = CODE.t[(uint8_t)s[i]];
    return;
  }
  u8x32 v;
  for (int64_t i = 0; i + 32 <= n; i += 32) {
    memcpy(&v, s + i, 32);
    v = codes32(v);
    memcpy(o + i, &v, 32);
  }
  memcpy(&v, s + n - 32, 32);  // the tail, overlapping the last full vector
  v = codes32(v);
  memcpy(o + n - 32, &v, 32);
}

}  // namespace

extern "C" {

// One pass over buf[offset..n) that writes its records straight into rows
// row0.. of a block being filled: codes and quals (rows x width), lens
// (rows), and, when hdrs is non-null, each header line ('@' included) into
// hdrs (rows x hdr_width) with hdr_lens. Each row it writes is written
// whole: the read, then 4 / qual_pad (0 for a header) to the row's end; no
// other row is touched. A record is complete when its four lines end in
// newlines; in a final buffer (final_buf != 0) the last line may end at n.
// Stops at the block's last row, at the first incomplete record, or before
// a record whose read is longer than width or whose header is longer than
// hdr_width. Returns the records written and sets out[0] to the offset
// after the last one (the next record's start), out[1] to the longest read
// written, and out[2] / out[3] to the read / header length of a record
// that did not fit (0 when none).
int64_t fastq_parse_into(const char* buf, int64_t n, int64_t offset, int32_t final_buf,
                         int64_t row0, int64_t rows, int64_t width, uint8_t qual_pad,
                         uint8_t* codes, uint8_t* quals, int32_t* lens,
                         int64_t hdr_width, uint8_t* hdrs, int32_t* hdr_lens,
                         int64_t* out) {
  const char* end = buf + n;
  const char* p = buf + offset;
  int64_t row = row0, longest = 0;
  out[2] = out[3] = 0;
  while (row < rows && p < end) {
    const char* h_end = find_nl(p, end);
    if (h_end >= end) break;
    const char* s_beg = h_end + 1;
    const char* s_end = find_nl(s_beg, end);
    if (s_end >= end) break;
    const char* plus_end = find_nl(s_end + 1, end);
    if (plus_end >= end) break;
    const char* q_beg = plus_end + 1;
    const char* q_end = find_nl(q_beg, end);
    if (q_end >= end && !final_buf) break;
    int64_t slen = s_end - s_beg, hlen = h_end - p;
    bool wide = slen > width, long_hdr = hdrs != nullptr && hlen > hdr_width;
    if (wide || long_hdr) {
      out[2] = wide ? slen : 0;
      out[3] = long_hdr ? hlen : 0;
      break;
    }
    uint8_t* crow = codes + row * width;
    to_codes(s_beg, crow, slen);
    memset(crow + slen, 4, width - slen);
    int64_t qlen = q_end - q_beg, QL = qlen < slen ? qlen : slen;
    uint8_t* qrow = quals + row * width;
    memcpy(qrow, q_beg, QL);
    memset(qrow + QL, qual_pad, width - QL);
    lens[row] = (int32_t)slen;
    if (hdrs != nullptr) {
      uint8_t* hrow = hdrs + row * hdr_width;
      memcpy(hrow, p, hlen);
      memset(hrow + hlen, 0, hdr_width - hlen);
      hdr_lens[row] = (int32_t)hlen;
    }
    if (slen > longest) longest = slen;
    ++row;
    p = q_end < end ? q_end + 1 : end;
  }
  out[0] = p - buf;
  out[1] = longest;
  return row - row0;
}

}  // extern "C"
