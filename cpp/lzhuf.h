// LZHUF — the LHA static-Huffman methods lh4..lh7.
//
// Parity: reference crate src/lzhuf/ (LzhufEncoder::new(&LzhufMethod),
// LzhufDecoder, [HIGH] names; SURVEY.md §0.1 Q4 resolves "lzhuf" to the
// static/canonical block-Huffman LHA scheme lh4-lh7, the survey's default).
// Stream layout per block (all MSB-first):
//   u16 token count;
//   T-table (code lengths of the C-length alphabet, 19 syms): 5-bit count,
//     3-bit lengths with unary extension past 7, 2-bit zero-skip after the
//     3rd entry; count==0 -> 5-bit constant symbol;
//   C-table (literals 0..255 + match lengths 3..256 as 256..509): 9-bit
//     count, lengths coded via T-Huffman (0 -> len 0; 1 -> 3+getbits(2)
//     zeros; 2 -> 20+getbits(9) zeros; s -> len s-2); count==0 -> 9-bit
//     constant symbol;
//   P-table (position MSB-count alphabet, np = dictbits+1): 4/5-bit count,
//     3-bit lengths with unary extension; count==0 -> constant;
//   tokens: C code; for matches a P code c plus c-1 raw bits encode
//     p = dist-1 (c = bit length of p), literal bytes are C codes < 256.
// The stream has no terminator: decode stops after orig_size bytes (LHA
// stores the size in the archive header; our container does too).
#pragma once

#include <cstdint>
#include <vector>

#include "bitio.h"
#include "lzss.h"

namespace tpz {

struct LzhufMethod {
  int dict_bits;  // lh4:12 lh5:13 lh6:15 lh7:16
  int np;         // dict_bits + 1 (lh4 shares lh5's np = 14)
  int pbit;       // bits for the P-table count field (4 for np<=14, else 5)
};

LzhufMethod LzhufMethodFor(int dict_bits);

// Tokens -> stream. Tokens must satisfy min_match 3, max_match 256,
// window 2^dict_bits. Block grouping: tokens_per_block at most 65535.
void LzhufEncode(const Token* tokens, size_t ntokens, const LzhufMethod& m,
                 BitWriterMSB* bw);

// Convenience: tokenize + encode with spec-v1 params (block_size 32768).
void LzhufEncodeBytes(const uint8_t* in, size_t n, const LzhufMethod& m,
                      int max_chain, BitWriterMSB* bw);

// Decode exactly orig_size bytes. Returns status (0/1/2, see common codes).
int LzhufDecode(const uint8_t* in, size_t n, const LzhufMethod& m,
                size_t orig_size, std::vector<uint8_t>* out);

// Resumable lzhuf decode for the streaming facade (tpz.api.DecodeStream):
// block headers and individual tokens are committed as they complete, so
// many small feeds cost O(total bytes) — the crate's pull-iterator cost —
// instead of a full re-parse per write (VERDICT r4 next item 9). The
// output vector retains the whole history (it IS the LZSS window);
// `taken` tracks what the caller has already drained.
class LzhufStream {
 public:
  LzhufStream(const LzhufMethod& m, uint64_t orig_size);
  ~LzhufStream();
  LzhufStream(const LzhufStream&) = delete;
  LzhufStream& operator=(const LzhufStream&) = delete;

  // Append compressed bytes and decode as far as they allow. Returns a
  // status: 0 while healthy (possibly mid-token, waiting for more
  // bytes), kStatusDataError once the stream is provably bad.
  int Feed(const uint8_t* data, size_t len);
  bool finished() const;  // produced == orig_size
  std::vector<uint8_t>& out();
  size_t taken = 0;

 private:
  struct Impl;
  Impl* impl_;
};

// Token-aligned segment index for the device decode (round 3; the lzhuf
// analogue of deflate.h InflateIndex): one host token walk, no output
// materialization. Segments cut at seg_out output bytes and at block
// (table) boundaries; a match straddling a cut re-enters the next
// segment as a (len, dist) carry. Per block: 510 c lens + 20 p lens and
// the constant-code escapes (-1 = real table). Declines (status 1) on
// code lengths > 17 (the device 15+2-bit table split).
int LzhufIndex(const uint8_t* in, size_t n, const LzhufMethod& m,
               size_t orig_size, int64_t seg_out, int64_t max_segs,
               int64_t max_blocks, int64_t* seg_bits, int64_t* end_bits,
               int64_t* out_lens, int32_t* carry_len, int32_t* carry_dist,
               int32_t* block_ids, uint8_t* c_lens, uint8_t* p_lens,
               int32_t* c_consts, int32_t* p_consts, int64_t* nseg_out,
               int64_t* nblk_out);

}  // namespace tpz

namespace tpz {
// Host planning for the device lzhuf pipeline: from per-block C/P histograms
// and token counts, build tables (MSB code values, no bit reversal) and
// emit all header bits at absolute offsets into header_stream
// (caller-zeroed). p_len/p_code rows are strided by 20 (np <= 17).
int LzhufPlan(const uint32_t* c_freq, const uint32_t* p_freq,
              const uint32_t* token_counts, int32_t nb, int32_t dict_bits,
              int64_t* body_bit_offset, int64_t* total_bits_out,
              uint8_t* c_len_out, uint16_t* c_code_out, uint8_t* p_len_out,
              uint16_t* p_code_out, uint8_t* header_stream,
              size_t header_cap);
}  // namespace tpz
