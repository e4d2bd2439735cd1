// DEFLATE (RFC 1951) encode/decode for the CPU oracle.
//
// Parity: reference crate src/deflate/ (Deflater/Inflater, stored/fixed/
// dynamic blocks, [MED] SURVEY.md §2.1; behavior pinned by RFC 1951, not by
// the crate's internals). Encode-side block/parse decisions follow "parse
// spec v1" (lzss.h) shared with the device kernels; one input block (64 KiB)
// maps to one DEFLATE block, chosen stored/fixed/dynamic by exact bit cost.
#pragma once

#include <cstdint>
#include <vector>

#include "bitio.h"
#include "lzss.h"

namespace tpz {

struct DeflateParams {
  LzssParams lzss;
  // Profile: "device" = greedy parse (device-parity); "max" = lazy host parse.
  static DeflateParams Profile(int level) {
    DeflateParams p;
    if (level <= 0) {  // fastest: tiny chain
      p.lzss.max_chain = 4;
      p.lzss.lazy = false;
    } else if (level <= 6) {  // default / device-parity
      p.lzss.max_chain = 32;  // K=32 is speed-neutral in the sorted-space
      p.lzss.lazy = false;    // screen (measured) and ~1% better ratio
    } else {  // max (host only)
      p.lzss.max_chain = 64;
      p.lzss.lazy = true;
    }
    return p;
  }
};

// Raw DEFLATE encode of in[0..n) into `bw` (whole stream, BFINAL on last
// block). With final_stream=false (Action::Flush semantics, reference
// src/action.rs [HIGH] SURVEY.md §2.1): no block carries BFINAL and a
// Z_SYNC_FLUSH-style empty stored block (BFINAL=0, BTYPE=00, LEN=0) is
// appended so the segment ends byte-aligned; concatenating flush segments
// plus one final segment forms a single valid RFC 1951 stream.
void DeflateEncode(const uint8_t* in, size_t n, const DeflateParams& params,
                   BitWriterLSB* bw, bool final_stream = true);

// Raw DEFLATE decode. Appends to *out. Returns a status code from
// common.h-style enum: 0 ok, 1 data error, 2 unexpected eof.
int Inflate(const uint8_t* in, size_t n, std::vector<uint8_t>* out,
            size_t* consumed_bytes /* nullable: bytes of `in` consumed */);

// Resumable raw-DEFLATE decoder for streaming decode facades (reference
// DecodeExt iterator adapters, SURVEY.md §2.1 "Encode/Decode traits"):
// Feed() accepts input increments and decodes as far as possible, keeping
// O(1) state (bit position, current block's tables, 32 KiB history ring)
// between calls — many small writes cost O(total), not O(n^2).
class InflateStream {
 public:
  InflateStream();
  ~InflateStream();
  InflateStream(const InflateStream&) = delete;
  InflateStream& operator=(const InflateStream&) = delete;

  // Append input and decode. Returns 0 ok (finished or need more input),
  // 1 data error (persistent).
  int Feed(const uint8_t* data, size_t len);
  bool finished() const;
  // Bytes of the overall input consumed by the complete stream (valid
  // once finished(); includes the final byte-alignment padding).
  uint64_t consumed_bytes() const;
  // Decoded bytes not yet taken by the caller.
  std::vector<uint8_t>& pending();

 private:
  struct Impl;
  Impl* impl_;
};

// Header-only scan for device-parallel decode: per encoder-indexed block
// (end_bits from the gzip 'TZ' side-car), parse the block header and
// export flat single-level decode tables ([nb, 1<<15] u32 entries of
// (sym << 5 | len)), body bit offsets, and stored-chunk byte layout.
//
// hdr_bits (nullable): explicit per-entry header bit positions — several
// entries may share one block header (mid-block segments from
// InflateIndex). Default: entry b's header starts at end_bits[b-1].
// seg_bits (nullable): explicit first-symbol bit per entry (mid-block
// segments); -1 or absent means "first symbol right after the header".
int InflateScanHeaders(const uint8_t* in, size_t n, const int64_t* end_bits,
                       int32_t nb, int32_t* btype, int64_t* body_bit,
                       int32_t* c0_pos, int32_t* c0_len, int32_t* c1_pos,
                       int32_t* c1_len, int32_t* lit_bits, int32_t* dist_bits,
                       uint32_t* lit_tab, uint32_t* dist_tab,
                       const int64_t* hdr_bits = nullptr,
                       const int64_t* seg_bits = nullptr);

// Token-aligned segment index over ANY raw DEFLATE stream (SURVEY.md §7.4
// route 2: no encoder side-car needed). One symbol-walk pass (no output
// materialization) cuts the stream into segments of exactly `seg_out`
// output bytes, additionally cutting at block-table boundaries; a match
// token straddling a cut is split and the remainder reported as a carry
// (len, dist) belonging to the following segment. Per segment s:
//   hdr_bits[s]  bit of the owning block's BFINAL bit (table source)
//   seg_bits[s]  first symbol bit of the segment
//   end_bits[s]  bit after the segment's last token (incl. EOB if the
//                block ends inside the segment)
//   out_lens[s]  output bytes (== seg_out except at cuts/stream end)
//   carry_len/carry_dist[s]  split-match remainder entering the segment
// Returns kStatusOk and *nseg_out; declines with kStatusDataError on
// stored blocks, > max_segs segments, or a segment whose compressed span
// exceeds max_span_bytes (callers fall back to the host decoder).
int InflateIndex(const uint8_t* in, size_t n, int64_t seg_out,
                 int64_t max_segs, int64_t max_span_bytes,
                 int64_t* hdr_bits, int64_t* seg_bits, int64_t* end_bits,
                 int64_t* out_lens, int32_t* carry_len, int32_t* carry_dist,
                 int64_t* nseg_out, size_t* consumed_bytes);

// Encode a pre-tokenized block sequence (for differential tests against the
// device pipeline): tokens for one DEFLATE block + the block's input span.
void DeflateEncodeBlock(const uint8_t* block_data, size_t block_len,
                        const Token* tokens, size_t ntokens, bool bfinal,
                        BitWriterLSB* bw);

// Host-side planning for the device encode pipeline: from per-block symbol
// histograms (device-computed), choose block types, build code tables
// (bit-reversed for LSB packing), emit every header bit at its absolute
// offset into `header_stream` (caller-zeroed; device body bits are ORed in
// afterwards), and report per-block body bit offsets.
// For stored blocks, body_bit_offset is chunk 0's data offset and
// chunk1_bit_offset the second 32 KiB chunk's (-1 if absent).
int DeflatePlan(const uint32_t* lit_freq, const uint32_t* dist_freq,
                const int64_t* block_lens, int32_t nb, int32_t* btype_out,
                int64_t* body_bit_offset, int64_t* chunk1_bit_offset,
                int64_t* total_bits_out, uint8_t* lit_len_out,
                uint16_t* lit_code_out, uint8_t* dist_len_out,
                uint16_t* dist_code_out, uint8_t* header_stream,
                size_t header_cap);

}  // namespace tpz
