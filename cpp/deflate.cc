#include "deflate.h"

#include <algorithm>
#include <atomic>
#include <cstring>
#include <thread>

#include "generated_constants.h"
#include "huffman.h"

namespace tpz {

namespace {

constexpr int kStatusOk = 0;
constexpr int kStatusDataError = 1;
constexpr int kStatusUnexpectedEof = 2;

// Stored chunk size: 32 KiB (spec v1 choice, not the RFC max 65535) so a
// 64 KiB input block maps to exactly two chunks and the device bitpack can
// compute chunk data offsets with a shift+mask (tpz/kernels/bitpack.py).
constexpr size_t kStoredChunk = 32768;

struct ClToken {
  uint8_t sym;        // 0..18
  uint8_t extra_bits; // 0, 2, 3 or 7
  uint8_t extra_val;
};

// RLE of the joint (litlen ++ dist) code-length sequence, RFC 1951 §3.2.7.
void ClEncode(const uint8_t* seq, int len, std::vector<ClToken>* out) {
  int i = 0;
  while (i < len) {
    uint8_t v = seq[i];
    int run = 1;
    while (i + run < len && seq[i + run] == v) ++run;
    if (v == 0) {
      int r = run;
      while (r >= 11) {
        int take = std::min(r, 138);
        out->push_back({18, 7, (uint8_t)(take - 11)});
        r -= take;
      }
      if (r >= 3) {
        out->push_back({17, 3, (uint8_t)(r - 3)});
        r = 0;
      }
      while (r-- > 0) out->push_back({0, 0, 0});
    } else {
      out->push_back({v, 0, 0});
      int r = run - 1;
      while (r >= 3) {
        int take = std::min(r, 6);
        out->push_back({16, 2, (uint8_t)(take - 3)});
        r -= take;
      }
      while (r-- > 0) out->push_back({v, 0, 0});
    }
    i += run;
  }
}

struct BlockPlan {
  uint32_t lit_freq[288] = {0};
  uint32_t dist_freq[32] = {0};
  uint64_t extra_bits_total = 0;
  uint8_t lit_len[288] = {0};
  uint8_t dist_len[32] = {0};
  uint32_t lit_code[288];
  uint32_t dist_code[32];
  int nlit = 257, ndist = 1, ncl = 4;
  uint8_t cl_len[19] = {0};
  uint32_t cl_code[19];
  std::vector<ClToken> cl_tokens;
  uint64_t dyn_body_bits = 0, dyn_header_bits = 0, fixed_body_bits = 0;
};

// Everything downstream of the histograms; shared by the oracle encoder
// and the device pipeline's host planning (tpz_deflate_plan) so the two can
// never diverge. lit_freq must NOT count EOB; it is forced to 1 here.
void PlanFromFreqs(BlockPlan* bp) {
  bp->lit_freq[256] = 1;  // EOB
  bp->extra_bits_total = 0;
  for (int s = 257; s < 286; ++s)
    bp->extra_bits_total += (uint64_t)bp->lit_freq[s] * kLengthExtra[s - 257];
  for (int s = 0; s < 30; ++s)
    bp->extra_bits_total += (uint64_t)bp->dist_freq[s] * kDistExtra[s];

  PackageMergeLengths(bp->lit_freq, 288, kDeflateMaxBits, bp->lit_len);
  PackageMergeLengths(bp->dist_freq, 30, kDeflateMaxBits, bp->dist_len);
  CanonicalCodes(bp->lit_len, 288, bp->lit_code);
  CanonicalCodes(bp->dist_len, 32, bp->dist_code);

  bp->nlit = 257;
  for (int i = 287; i >= 257; --i)
    if (bp->lit_len[i]) {
      bp->nlit = i + 1;
      break;
    }
  bp->ndist = 1;
  for (int i = 29; i >= 1; --i)
    if (bp->dist_len[i]) {
      bp->ndist = i + 1;
      break;
    }

  uint8_t joint[288 + 32];
  std::memcpy(joint, bp->lit_len, bp->nlit);
  std::memcpy(joint + bp->nlit, bp->dist_len, bp->ndist);
  bp->cl_tokens.clear();
  ClEncode(joint, bp->nlit + bp->ndist, &bp->cl_tokens);

  uint32_t cl_freq[19] = {0};
  for (const auto& c : bp->cl_tokens) ++cl_freq[c.sym];
  PackageMergeLengths(cl_freq, 19, kDeflateMaxClBits, bp->cl_len);
  CanonicalCodes(bp->cl_len, 19, bp->cl_code);
  bp->ncl = 4;
  for (int i = 18; i >= 4; --i)
    if (bp->cl_len[kClOrder[i]]) {
      bp->ncl = i + 1;
      break;
    }

  bp->dyn_header_bits = 5 + 5 + 4 + 3ull * bp->ncl;
  for (const auto& c : bp->cl_tokens)
    bp->dyn_header_bits += bp->cl_len[c.sym] + c.extra_bits;

  uint64_t dyn = 0, fixed = 0;
  for (int s = 0; s < 288; ++s)
    if (bp->lit_freq[s]) {
      dyn += (uint64_t)bp->lit_freq[s] * bp->lit_len[s];
      fixed += (uint64_t)bp->lit_freq[s] * kFixedLitLenLengths[s];
    }
  for (int s = 0; s < 30; ++s)
    if (bp->dist_freq[s]) {
      dyn += (uint64_t)bp->dist_freq[s] * bp->dist_len[s];
      fixed += (uint64_t)bp->dist_freq[s] * kFixedDistLengths[s];
    }
  bp->dyn_body_bits = dyn + bp->extra_bits_total;
  bp->fixed_body_bits = fixed + bp->extra_bits_total;
}

void PlanBlock(const Token* tokens, size_t ntokens, BlockPlan* bp) {
  for (size_t t = 0; t < ntokens; ++t) {
    const Token& tok = tokens[t];
    if (tok.len == 0) {
      ++bp->lit_freq[tok.lit];
    } else {
      ++bp->lit_freq[kLengthSymTable[tok.len]];
      int ds = (tok.dist <= 256) ? kDistSymLo[tok.dist - 1]
                                 : kDistSymHi[(tok.dist - 1) >> 7];
      ++bp->dist_freq[ds];
    }
  }
  PlanFromFreqs(bp);
}

uint64_t StoredCost(uint64_t start_bits, size_t block_len) {
  uint64_t pos = start_bits;
  size_t remaining = block_len;
  do {
    pos += 3;
    pos += (8 - (pos & 7)) & 7;
    pos += 32;
    size_t chunk = std::min<size_t>(remaining, kStoredChunk);
    pos += 8 * chunk;
    remaining -= chunk;
  } while (remaining > 0);
  return pos - start_bits;
}

// btype + (for dynamic) table description. Templated over the writer so the
// oracle's streaming BitWriterLSB and the plan API's absolute-offset OR
// writer share one emission path.
template <typename Writer>
void EmitBlockHeader(const BlockPlan& bp, int btype, bool bfinal, Writer* bw) {
  bw->Write(bfinal ? 1 : 0, 1);
  bw->Write((uint32_t)btype, 2);
  if (btype != 2) return;
  bw->Write(bp.nlit - 257, 5);
  bw->Write(bp.ndist - 1, 5);
  bw->Write(bp.ncl - 4, 4);
  for (int i = 0; i < bp.ncl; ++i) bw->Write(bp.cl_len[kClOrder[i]], 3);
  for (const auto& c : bp.cl_tokens) {
    bw->WriteHuff(bp.cl_code[c.sym], bp.cl_len[c.sym]);
    if (c.extra_bits) bw->Write(c.extra_val, c.extra_bits);
  }
}

struct FixedCodes {
  uint8_t fl_len[288];
  uint8_t fd_len[32];
  uint32_t fl_code[288];
  uint32_t fd_code[32];
  FixedCodes() {
    std::memcpy(fl_len, kFixedLitLenLengths, 288);
    std::memcpy(fd_len, kFixedDistLengths, 30);
    fd_len[30] = fd_len[31] = 5;
    CanonicalCodes(fl_len, 288, fl_code);
    CanonicalCodes(fd_len, 32, fd_code);
  }
};

const FixedCodes& GetFixedCodes() {
  static FixedCodes c;
  return c;
}

void EmitSymbols(const Token* tokens, size_t ntokens, const uint8_t* lit_len,
                 const uint32_t* lit_code, const uint8_t* dist_len,
                 const uint32_t* dist_code, BitWriterLSB* bw) {
  for (size_t t = 0; t < ntokens; ++t) {
    const Token& tok = tokens[t];
    if (tok.len == 0) {
      bw->WriteHuff(lit_code[tok.lit], lit_len[tok.lit]);
    } else {
      int ls = kLengthSymTable[tok.len];
      bw->WriteHuff(lit_code[ls], lit_len[ls]);
      bw->Write((uint32_t)(tok.len - kLengthBase[ls - 257]),
                kLengthExtra[ls - 257]);
      int ds = (tok.dist <= 256) ? kDistSymLo[tok.dist - 1]
                                 : kDistSymHi[(tok.dist - 1) >> 7];
      bw->WriteHuff(dist_code[ds], dist_len[ds]);
      bw->Write(tok.dist - kDistBase[ds], kDistExtra[ds]);
    }
  }
  bw->WriteHuff(lit_code[256], lit_len[256]);  // EOB
}

void EmitStored(const uint8_t* data, size_t len, bool bfinal, BitWriterLSB* bw) {
  size_t off = 0;
  do {
    size_t chunk = std::min<size_t>(len - off, kStoredChunk);
    bool last_chunk = (off + chunk == len);
    bw->Write((bfinal && last_chunk) ? 1 : 0, 1);
    bw->Write(0, 2);  // BTYPE=00
    bw->AlignByte();
    bw->Write((uint32_t)chunk, 16);
    bw->Write((uint32_t)(~chunk) & 0xffff, 16);
    bw->WriteBytes(data + off, chunk);
    off += chunk;
  } while (off < len);
}

int ChooseBtype(const BlockPlan& bp, uint64_t start_bits, size_t block_len,
                uint64_t* cost_out) {
  uint64_t dyn_cost = 3 + bp.dyn_header_bits + bp.dyn_body_bits;
  uint64_t fixed_cost = 3 + bp.fixed_body_bits;
  uint64_t stored_cost = StoredCost(start_bits, block_len);
  if (block_len > 0 && stored_cost < dyn_cost && stored_cost < fixed_cost) {
    *cost_out = stored_cost;
    return 0;
  }
  if (fixed_cost <= dyn_cost) {
    *cost_out = fixed_cost;
    return 1;
  }
  *cost_out = dyn_cost;
  return 2;
}

}  // namespace

void DeflateEncodeBlock(const uint8_t* block_data, size_t block_len,
                        const Token* tokens, size_t ntokens, bool bfinal,
                        BitWriterLSB* bw) {
  BlockPlan bp;
  PlanBlock(tokens, ntokens, &bp);
  uint64_t cost;
  int btype = ChooseBtype(bp, bw->BitLength(), block_len, &cost);
  if (btype == 0) {
    EmitStored(block_data, block_len, bfinal, bw);
    return;
  }
  EmitBlockHeader(bp, btype, bfinal, bw);
  if (btype == 1) {
    const FixedCodes& f = GetFixedCodes();
    EmitSymbols(tokens, ntokens, f.fl_len, f.fl_code, f.fd_len, f.fd_code, bw);
  } else {
    EmitSymbols(tokens, ntokens, bp.lit_len, bp.lit_code, bp.dist_len,
                bp.dist_code, bw);
  }
}

namespace {
// Z_SYNC_FLUSH marker: empty stored block, BFINAL=0, ends byte-aligned.
void EmitSyncFlush(BitWriterLSB* bw) {
  bw->Write(0, 1);
  bw->Write(0, 2);
  bw->AlignByte();
  bw->Write(0x0000, 16);
  bw->Write(0xFFFF, 16);
}
}  // namespace

void DeflateEncode(const uint8_t* in, size_t n, const DeflateParams& params,
                   BitWriterLSB* bw, bool final_stream) {
  std::vector<Token> tokens;
  LzssTokenize(in, n, params.lzss, &tokens);
  if (n == 0) {
    if (final_stream) {
      DeflateEncodeBlock(in, 0, nullptr, 0, true, bw);
      bw->AlignByte();
    } else {
      EmitSyncFlush(bw);
    }
    return;
  }
  const size_t bs = (size_t)params.lzss.block_size;
  // Parallel phase: per-block planning and speculative dynamic/fixed body
  // emission (offset-independent bits). Serial phase: block-type choice
  // (stored cost depends on the absolute bit position) + ordered splice;
  // stored blocks are emitted serially. Byte-identical to the serial loop.
  struct Job {
    size_t start, end, t0, t1;
    BlockPlan bp;
    BitWriterLSB body;  // header + symbols for the dyn/fixed choice
    int pre_btype;      // 1 or 2 (cheaper of the two); 0 decided serially
  };
  std::vector<Job> jobs;
  {
    size_t t = 0;
    for (size_t start = 0; start < n; start += bs) {
      size_t end = std::min(n, start + bs);
      size_t t0 = t;
      while (t < tokens.size() && tokens[t].pos < end) ++t;
      jobs.push_back(Job{start, end, t0, t, {}, {}, 1});
    }
  }
  std::atomic<size_t> next(0);
  auto worker = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= jobs.size()) return;
      Job& j = jobs[i];
      PlanBlock(tokens.data() + j.t0, j.t1 - j.t0, &j.bp);
      uint64_t dyn_cost = 3 + j.bp.dyn_header_bits + j.bp.dyn_body_bits;
      uint64_t fixed_cost = 3 + j.bp.fixed_body_bits;
      j.pre_btype = fixed_cost <= dyn_cost ? 1 : 2;
      bool bfinal = final_stream && i + 1 == jobs.size();
      EmitBlockHeader(j.bp, j.pre_btype, bfinal, &j.body);
      if (j.pre_btype == 1) {
        const FixedCodes& f = GetFixedCodes();
        EmitSymbols(tokens.data() + j.t0, j.t1 - j.t0, f.fl_len, f.fl_code,
                    f.fd_len, f.fd_code, &j.body);
      } else {
        EmitSymbols(tokens.data() + j.t0, j.t1 - j.t0, j.bp.lit_len,
                    j.bp.lit_code, j.bp.dist_len, j.bp.dist_code, &j.body);
      }
    }
  };
  unsigned nt = std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > jobs.size()) nt = (unsigned)jobs.size();
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    for (unsigned t2 = 0; t2 < nt; ++t2) ts.emplace_back(worker);
    for (auto& t2 : ts) t2.join();
  }
  for (size_t i = 0; i < jobs.size(); ++i) {
    Job& j = jobs[i];
    uint64_t cost;
    int btype = ChooseBtype(j.bp, bw->BitLength(), j.end - j.start, &cost);
    if (btype == 0) {
      EmitStored(in + j.start, j.end - j.start,
                 final_stream && i + 1 == jobs.size(), bw);
    } else {
      // btype matches pre_btype: ChooseBtype picks stored only when it
      // beats BOTH, else the same dyn/fixed comparison as the worker.
      j.body.AppendTo(bw);
    }
  }
  if (final_stream)
    bw->AlignByte();
  else
    EmitSyncFlush(bw);
}

// ---------------------------------------------------------------------------
// Planning API for the device pipeline (host side of the device encode)
// ---------------------------------------------------------------------------

namespace {

// LSB-first bit writer that ORs into a caller-provided buffer at absolute
// bit offsets (the device packs body bits into the same bit-space; the two
// are merged with a plain byte OR).
class AbsBitWriter {
 public:
  AbsBitWriter(uint8_t* buf, size_t cap_bytes, uint64_t pos)
      : buf_(buf), cap_(cap_bytes), pos_(pos) {}
  void Write(uint32_t value, int nbits) {
    uint64_t v = value & ((nbits >= 32) ? 0xffffffffull : ((1ull << nbits) - 1));
    uint64_t byte = pos_ >> 3;
    int shift = (int)(pos_ & 7);
    uint64_t payload = v << shift;
    int total = shift + nbits;
    for (int b = 0; b * 8 < total && byte + b < cap_; ++b)
      buf_[byte + b] |= (uint8_t)((payload >> (8 * b)) & 0xff);
    pos_ += nbits;
  }
  void WriteHuff(uint32_t code, int nbits) {
    uint32_t rev = 0;
    for (int i = 0; i < nbits; ++i) {
      rev = (rev << 1) | (code & 1);
      code >>= 1;
    }
    Write(rev, nbits);
  }
  uint64_t pos() const { return pos_; }
  void set_pos(uint64_t p) { pos_ = p; }

 private:
  uint8_t* buf_;
  size_t cap_;
  uint64_t pos_;
};

}  // namespace

int DeflatePlan(const uint32_t* lit_freq, const uint32_t* dist_freq,
                const int64_t* block_lens, int32_t nb, int32_t* btype_out,
                int64_t* body_bit_offset, int64_t* chunk1_bit_offset,
                int64_t* total_bits_out, uint8_t* lit_len_out,
                uint16_t* lit_code_out, uint8_t* dist_len_out,
                uint16_t* dist_code_out, uint8_t* header_stream,
                size_t header_cap) {
  uint64_t pos = 0;
  for (int b = 0; b < nb; ++b) {
    BlockPlan bp;
    std::memcpy(bp.lit_freq, lit_freq + (size_t)b * 288, 288 * 4);
    std::memcpy(bp.dist_freq, dist_freq + (size_t)b * 30, 30 * 4);
    bp.lit_freq[256] = 0;  // PlanFromFreqs forces EOB = 1
    PlanFromFreqs(&bp);
    uint64_t cost;
    bool bfinal = b == nb - 1;
    int btype = ChooseBtype(bp, pos, (size_t)block_lens[b], &cost);
    btype_out[b] = btype;
    chunk1_bit_offset[b] = -1;
    AbsBitWriter aw(header_stream, header_cap, pos);
    const uint8_t* ll;
    const uint32_t* lc;
    const uint8_t* dl;
    const uint32_t* dc;
    if (btype == 0) {
      size_t remaining = (size_t)block_lens[b];
      size_t off = 0;
      int chunk_i = 0;
      do {
        size_t chunk = std::min<size_t>(remaining, kStoredChunk);
        bool last_chunk = (off + chunk == (size_t)block_lens[b]);
        aw.Write((bfinal && last_chunk) ? 1 : 0, 1);
        aw.Write(0, 2);
        uint64_t p2 = aw.pos();
        aw.set_pos(p2 + ((8 - (p2 & 7)) & 7));  // align (zero pad = no-op OR)
        aw.Write((uint32_t)chunk, 16);
        aw.Write((uint32_t)(~chunk) & 0xffff, 16);
        if (chunk_i == 0)
          body_bit_offset[b] = (int64_t)aw.pos();
        else
          chunk1_bit_offset[b] = (int64_t)aw.pos();
        aw.set_pos(aw.pos() + 8 * chunk);  // device fills the bytes
        off += chunk;
        remaining -= chunk;
        ++chunk_i;
      } while (remaining > 0);
      ll = nullptr; lc = nullptr; dl = nullptr; dc = nullptr;
      std::memset(lit_len_out + (size_t)b * 288, 0, 288);
      std::memset(dist_len_out + (size_t)b * 30, 0, 30);
      std::memset(lit_code_out + (size_t)b * 288, 0, 288 * 2);
      std::memset(dist_code_out + (size_t)b * 30, 0, 30 * 2);
    } else {
      EmitBlockHeader(bp, btype, bfinal, &aw);
      body_bit_offset[b] = (int64_t)aw.pos();
      if (btype == 1) {
        const FixedCodes& f = GetFixedCodes();
        ll = f.fl_len; lc = f.fl_code; dl = f.fd_len; dc = f.fd_code;
      } else {
        ll = bp.lit_len; lc = bp.lit_code; dl = bp.dist_len; dc = bp.dist_code;
      }
      // Export bit-REVERSED codes, ready for LSB-first packing on device.
      for (int s = 0; s < 288; ++s) {
        lit_len_out[(size_t)b * 288 + s] = ll[s];
        uint32_t code = lc[s], rev = 0;
        for (int i = 0; i < ll[s]; ++i) {
          rev = (rev << 1) | (code & 1);
          code >>= 1;
        }
        lit_code_out[(size_t)b * 288 + s] = (uint16_t)rev;
      }
      for (int s = 0; s < 30; ++s) {
        dist_len_out[(size_t)b * 30 + s] = dl[s];
        uint32_t code = dc[s], rev = 0;
        for (int i = 0; i < dl[s]; ++i) {
          rev = (rev << 1) | (code & 1);
          code >>= 1;
        }
        dist_code_out[(size_t)b * 30 + s] = (uint16_t)rev;
      }
    }
    pos += cost;
  }
  *total_bits_out = (int64_t)pos;
  return 0;
}

// ---------------------------------------------------------------------------
// Inflate
// ---------------------------------------------------------------------------

namespace {

struct FixedTables {
  HuffDecodeTable lit, dist;
  FixedTables() {
    BuildDecodeTable(kFixedLitLenLengths, 288, /*lsb=*/true, &lit);
    uint8_t fd[32];
    std::memcpy(fd, kFixedDistLengths, 30);
    fd[30] = fd[31] = 5;
    BuildDecodeTable(fd, 32, /*lsb=*/true, &dist);
  }
};

const FixedTables& GetFixedTables() {
  static FixedTables t;
  return t;
}

// Decode one Huffman symbol via single-level table; returns -1 on invalid.
inline int DecodeSym(BitReaderLSB* br, const HuffDecodeTable& t) {
  br->Fill();
  uint32_t e = t.entries[br->Peek(t.bits)];
  int len = (int)(e & 0x1f);
  if (len == 0) return -1;
  br->Consume(len);
  return (int)(e >> 5);
}

}  // namespace

int Inflate(const uint8_t* in, size_t n, std::vector<uint8_t>* out,
            size_t* consumed_bytes) {
  BitReaderLSB br(in, n);
  bool bfinal = false;
  while (!bfinal) {
    bfinal = br.Read(1) != 0;
    uint32_t btype = br.Read(2);
    if (br.Overrun()) return kStatusUnexpectedEof;
    if (btype == 3) return kStatusDataError;
    if (btype == 0) {
      br.AlignByte();
      uint32_t len = br.Read(16);
      uint32_t nlen = br.Read(16);
      if (br.Overrun()) return kStatusUnexpectedEof;
      if ((len ^ nlen) != 0xffff) return kStatusDataError;
      size_t p = br.BytePos();
      if (p + len > n) return kStatusUnexpectedEof;
      out->insert(out->end(), in + p, in + p + len);
      br.SeekByte(p + len);
      continue;
    }
    HuffDecodeTable dyn_lit, dyn_dist;
    const HuffDecodeTable* lit;
    const HuffDecodeTable* dist;
    if (btype == 1) {
      lit = &GetFixedTables().lit;
      dist = &GetFixedTables().dist;
    } else {
      uint32_t hlit = br.Read(5) + 257;
      uint32_t hdist = br.Read(5) + 1;
      uint32_t hclen = br.Read(4) + 4;
      uint8_t cl_len[19] = {0};
      for (uint32_t i = 0; i < hclen; ++i)
        cl_len[kClOrder[i]] = (uint8_t)br.Read(3);
      if (br.Overrun()) return kStatusUnexpectedEof;
      HuffDecodeTable cl;
      if (!BuildDecodeTable(cl_len, 19, /*lsb=*/true, &cl) || cl.bits == 0)
        return kStatusDataError;
      uint8_t lens[288 + 32] = {0};
      uint32_t total = hlit + hdist;
      uint32_t i = 0;
      while (i < total) {
        int sym = DecodeSym(&br, cl);
        if (br.Overrun()) return kStatusUnexpectedEof;
        if (sym < 0) return kStatusDataError;
        if (sym < 16) {
          lens[i++] = (uint8_t)sym;
        } else if (sym == 16) {
          if (i == 0) return kStatusDataError;
          uint32_t rep = 3 + br.Read(2);
          if (i + rep > total) return kStatusDataError;
          uint8_t v = lens[i - 1];
          while (rep--) lens[i++] = v;
        } else if (sym == 17) {
          uint32_t rep = 3 + br.Read(3);
          if (i + rep > total) return kStatusDataError;
          i += rep;
        } else {
          uint32_t rep = 11 + br.Read(7);
          if (i + rep > total) return kStatusDataError;
          i += rep;
        }
      }
      if (br.Overrun()) return kStatusUnexpectedEof;
      if (!BuildDecodeTable(lens, (int)hlit, /*lsb=*/true, &dyn_lit))
        return kStatusDataError;
      uint8_t dlens[32] = {0};
      std::memcpy(dlens, lens + hlit, hdist);
      if (!BuildDecodeTable(dlens, (int)hdist, /*lsb=*/true, &dyn_dist))
        return kStatusDataError;
      if (dyn_lit.bits == 0) return kStatusDataError;  // no litlen codes
      lit = &dyn_lit;
      dist = &dyn_dist;
    }
    // Symbol loop.
    for (;;) {
      int sym = DecodeSym(&br, *lit);
      if (br.Overrun()) return kStatusUnexpectedEof;
      if (sym < 0) return kStatusDataError;
      if (sym < 256) {
        out->push_back((uint8_t)sym);
        continue;
      }
      if (sym == 256) break;
      if (sym > 285) return kStatusDataError;
      uint32_t len = kLengthBase[sym - 257] + br.Read(kLengthExtra[sym - 257]);
      if (dist->bits == 0) return kStatusDataError;
      int ds = DecodeSym(&br, *dist);
      if (br.Overrun()) return kStatusUnexpectedEof;
      if (ds < 0 || ds > 29) return kStatusDataError;
      uint32_t d = kDistBase[ds] + br.Read(kDistExtra[ds]);
      if (br.Overrun()) return kStatusUnexpectedEof;
      if (d > out->size()) return kStatusDataError;
      // Bulk match copy: resize once, then memcpy for the non-overlapping
      // case; overlapping copies double the copyable span each pass.
      size_t from = out->size() - d;
      size_t oldsz = out->size();
      out->resize(oldsz + len);
      uint8_t* dst = out->data() + oldsz;
      const uint8_t* src = out->data() + from;
      if (d >= len) {
        std::memcpy(dst, src, len);
      } else {
        size_t done = d;
        std::memcpy(dst, src, d);
        while (done < len) {
          size_t chunk = std::min(done, len - done);
          std::memcpy(dst + done, dst, chunk);
          done += chunk;
        }
      }
    }
  }
  br.AlignByte();
  if (br.Overrun()) return kStatusUnexpectedEof;
  if (consumed_bytes) *consumed_bytes = br.BytePos();
  return kStatusOk;
}

// ---------------------------------------------------------------------------
// Resumable inflate (streaming decode facade backend)
// ---------------------------------------------------------------------------

struct InflateStream::Impl {
  enum State { kBlockHeader, kStoredData, kSymbols, kDone, kError };

  std::vector<uint8_t> in;   // unconsumed input tail
  uint64_t in_base = 0;      // bytes dropped from the front of the stream
  uint64_t bitpos = 0;       // absolute bit position of the next decode
  std::vector<uint8_t> out;  // decoded bytes not yet taken
  uint8_t hist[32768];       // history ring over ALL output (window source)
  uint64_t total_out = 0;
  State state = kBlockHeader;
  bool bfinal = false;
  uint32_t stored_remaining = 0;
  HuffDecodeTable lit, dist;

  void Emit(uint8_t b) {
    out.push_back(b);
    hist[total_out & 32767] = b;
    ++total_out;
  }

  // Decode as far as the buffered input allows. Every symbol/table/header
  // consumes from a checkpointed bit position; an overrun rolls back to
  // the checkpoint so the next Feed resumes exactly there.
  int Run() {
    for (;;) {
      switch (state) {
        case kDone:
          return kStatusOk;
        case kError:
          return kStatusDataError;
        case kStoredData: {
          uint64_t p = bitpos >> 3;  // byte-aligned by construction
          uint64_t avail = in_base + in.size() - p;
          uint64_t take = std::min<uint64_t>(avail, stored_remaining);
          const uint8_t* src = in.data() + (p - in_base);
          for (uint64_t i = 0; i < take; ++i) Emit(src[i]);
          stored_remaining -= (uint32_t)take;
          bitpos += 8 * take;
          if (stored_remaining > 0) return kStatusOk;  // need more input
          state = bfinal ? kDone : kBlockHeader;
          continue;
        }
        case kBlockHeader: {
          uint64_t cp = bitpos;
          BitReaderLSB br(in.data(), in.size());
          br.SeekByte((size_t)((cp >> 3) - in_base));
          if (cp & 7) br.Read((int)(cp & 7));
          bool bf = br.Read(1) != 0;
          uint32_t btype = br.Read(2);
          if (br.Overrun()) return kStatusOk;  // need more
          if (btype == 3) {
            state = kError;
            return kStatusDataError;
          }
          if (btype == 0) {
            br.AlignByte();
            uint32_t len = br.Read(16);
            uint32_t nlen = br.Read(16);
            if (br.Overrun()) return kStatusOk;
            if ((len ^ nlen) != 0xffff) {
              state = kError;
              return kStatusDataError;
            }
            bfinal = bf;
            stored_remaining = len;
            bitpos = 8 * in_base + br.BitPos();
            state = kStoredData;
            continue;
          }
          if (btype == 1) {
            lit = GetFixedTables().lit;
            dist = GetFixedTables().dist;
          } else {
            uint32_t hlit = br.Read(5) + 257;
            uint32_t hdist = br.Read(5) + 1;
            uint32_t hclen = br.Read(4) + 4;
            uint8_t cl_len[19] = {0};
            for (uint32_t i = 0; i < hclen; ++i)
              cl_len[kClOrder[i]] = (uint8_t)br.Read(3);
            if (br.Overrun()) return kStatusOk;
            HuffDecodeTable cl;
            if (!BuildDecodeTable(cl_len, 19, true, &cl) || cl.bits == 0) {
              state = kError;
              return kStatusDataError;
            }
            uint8_t lens[288 + 32] = {0};
            uint32_t total = hlit + hdist;
            uint32_t i = 0;
            while (i < total) {
              int sym = DecodeSym(&br, cl);
              if (br.Overrun()) return kStatusOk;
              if (sym < 0) {
                state = kError;
                return kStatusDataError;
              }
              if (sym < 16) {
                lens[i++] = (uint8_t)sym;
              } else if (sym == 16) {
                if (i == 0) {
                  state = kError;
                  return kStatusDataError;
                }
                uint32_t rep = 3 + br.Read(2);
                if (i + rep > total) {
                  state = kError;
                  return kStatusDataError;
                }
                uint8_t v = lens[i - 1];
                while (rep--) lens[i++] = v;
              } else if (sym == 17) {
                uint32_t rep = 3 + br.Read(3);
                if (i + rep > total) {
                  state = kError;
                  return kStatusDataError;
                }
                i += rep;
              } else {
                uint32_t rep = 11 + br.Read(7);
                if (i + rep > total) {
                  state = kError;
                  return kStatusDataError;
                }
                i += rep;
              }
            }
            if (br.Overrun()) return kStatusOk;
            uint8_t dlens[32] = {0};
            std::memcpy(dlens, lens + hlit, hdist);
            if (!BuildDecodeTable(lens, (int)hlit, true, &lit) ||
                !BuildDecodeTable(dlens, (int)hdist, true, &dist) ||
                lit.bits == 0) {
              state = kError;
              return kStatusDataError;
            }
          }
          bfinal = bf;
          bitpos = 8 * in_base + br.BitPos();
          state = kSymbols;
          continue;
        }
        case kSymbols: {
          BitReaderLSB br(in.data(), in.size());
          br.SeekByte((size_t)((bitpos >> 3) - in_base));
          if (bitpos & 7) br.Read((int)(bitpos & 7));
          for (;;) {
            int sym = DecodeSym(&br, lit);
            if (br.Overrun()) return kStatusOk;  // rollback to bitpos
            if (sym < 0) {
              state = kError;
              return kStatusDataError;
            }
            if (sym < 256) {
              Emit((uint8_t)sym);
              bitpos = 8 * in_base + br.BitPos();
              continue;
            }
            if (sym == 256) {
              bitpos = 8 * in_base + br.BitPos();
              state = bfinal ? kDone : kBlockHeader;
              break;
            }
            if (sym > 285) {
              state = kError;
              return kStatusDataError;
            }
            uint32_t len =
                kLengthBase[sym - 257] + br.Read(kLengthExtra[sym - 257]);
            if (dist.bits == 0) {
              state = kError;
              return kStatusDataError;
            }
            int ds = DecodeSym(&br, dist);
            if (br.Overrun()) return kStatusOk;
            if (ds < 0 || ds > 29) {
              state = kError;
              return kStatusDataError;
            }
            uint32_t d = kDistBase[ds] + br.Read(kDistExtra[ds]);
            if (br.Overrun()) return kStatusOk;
            if (d > total_out) {
              state = kError;
              return kStatusDataError;
            }
            for (uint32_t k2 = 0; k2 < len; ++k2)
              Emit(hist[(total_out - d) & 32767]);
            bitpos = 8 * in_base + br.BitPos();
          }
          continue;
        }
      }
    }
  }
};

InflateStream::InflateStream() : impl_(new Impl) {}
InflateStream::~InflateStream() { delete impl_; }

int InflateStream::Feed(const uint8_t* data, size_t len) {
  if (impl_->state == Impl::kError) return kStatusDataError;
  impl_->in.insert(impl_->in.end(), data, data + len);
  int st = impl_->Run();
  // Drop the consumed prefix so memory stays O(window), not O(stream).
  uint64_t keep_from = (impl_->bitpos >> 3) - impl_->in_base;
  if (keep_from > 4096) {
    impl_->in.erase(impl_->in.begin(), impl_->in.begin() + keep_from);
    impl_->in_base += keep_from;
  }
  return st;
}

bool InflateStream::finished() const { return impl_->state == Impl::kDone; }

uint64_t InflateStream::consumed_bytes() const {
  return (impl_->bitpos + 7) >> 3;
}

std::vector<uint8_t>& InflateStream::pending() { return impl_->out; }

// ---------------------------------------------------------------------------
// Header scan for device-parallel decode (SURVEY.md §7.4): given the
// encoder's per-block end-bit index (gzip FEXTRA 'TZ' side-car), parse
// ONLY the block headers — O(tables), no symbol scan — and export flat
// single-level decode tables + body offsets for the device symbol walk
// (tpz/kernels/inflate_pipeline.py).
// ---------------------------------------------------------------------------

// Two-level LSB table emit (round 4, see tpz/constants.py INFLATE_*):
// l1 has 1 << kInflateL1Bits entries; a class whose codes all fit
// kInflateL1Bits bits stores its (sym << 5 | len) entry directly, the
// rest escape (len sentinel 31) into a 32-entry level-2 chunk indexed
// by the peek's next 5 bits. Mask replication (peeks past 2^bits wrap)
// is baked in, so the walk needs no per-block peek mask. Returns false
// when the l2 capacity is exceeded (caller declines that block to the
// host decoder).
static bool EmitTwoLevelLSB(const HuffDecodeTable& t, uint32_t* l1,
                            uint32_t* l2, int l2cap) {
  constexpr uint32_t kL1 = 1u << kInflateL1Bits;
  if (t.bits == 0) {
    std::memset(l1, 0, 4 * kL1);
    return true;
  }
  const uint32_t mask = (1u << t.bits) - 1;
  int l2n = 0;
  for (uint32_t idx = 0; idx < kL1; ++idx) {
    uint32_t e0 = t.entries[idx & mask];
    uint32_t ln = e0 & 31;
    if (ln > 0 && ln <= (uint32_t)kInflateL1Bits) {
      l1[idx] = e0;
      continue;
    }
    // Class holds long codes (or is wholly invalid): emit a chunk.
    bool any = false;
    for (int j = 0; j < 32; ++j)
      any |= t.entries[(idx + ((uint32_t)j << kInflateL1Bits)) & mask] != 0;
    if (!any) {
      l1[idx] = 0;
      continue;
    }
    if (l2n + 32 > l2cap) return false;
    for (int j = 0; j < 32; ++j)
      l2[l2n + j] =
          t.entries[(idx + ((uint32_t)j << kInflateL1Bits)) & mask];
    l1[idx] = ((uint32_t)l2n << 5) | 31;
    l2n += 32;
  }
  return true;
}

int InflateScanHeaders(const uint8_t* in, size_t n, const int64_t* end_bits,
                       int32_t nb, int32_t* btype_out, int64_t* body_bit,
                       int32_t* c0_pos, int32_t* c0_len, int32_t* c1_pos,
                       int32_t* c1_len, int32_t* lit_bits, int32_t* dist_bits,
                       uint32_t* lit_tab, uint32_t* dist_tab,
                       const int64_t* hdr_bits, const int64_t* seg_bits) {
  constexpr size_t kL1 = 1u << kInflateL1Bits;
  constexpr size_t kLitTW = kL1 + kInflateLitL2;
  constexpr size_t kDistTW = kL1 + kInflateDistL2;
  for (int32_t b = 0; b < nb; ++b) {
    int64_t start = hdr_bits ? hdr_bits[b] : (b == 0 ? 0 : end_bits[b - 1]);
    int64_t end = end_bits[b];
    if (start < 0 || end > (int64_t)(8 * n) || start >= end)
      return kStatusDataError;
    BitReaderLSB br(in, n);
    br.SeekByte((size_t)(start >> 3));
    if (start & 7) br.Read((int)(start & 7));
    btype_out[b] = -1;
    body_bit[b] = 0;
    c0_pos[b] = c0_len[b] = c1_pos[b] = c1_len[b] = 0;
    lit_bits[b] = dist_bits[b] = 0;

    br.Read(1);  // BFINAL (the index already delimits blocks)
    uint32_t btype = br.Read(2);
    if (br.Overrun() || btype == 3) return kStatusDataError;
    btype_out[b] = (int32_t)btype;
    if (btype == 0) {
      // Chunked stored block: parse chunk headers until the block end.
      int chunk = 0;
      br.AlignByte();
      for (;;) {
        uint32_t len = br.Read(16);
        uint32_t nlen = br.Read(16);
        if (br.Overrun() || ((len ^ nlen) != 0xffff))
          return kStatusDataError;
        size_t p = br.BytePos();
        if (p + len > n) return kStatusUnexpectedEof;
        if (chunk == 0) {
          c0_pos[b] = (int32_t)p;
          c0_len[b] = (int32_t)len;
        } else if (chunk == 1) {
          c1_pos[b] = (int32_t)p;
          c1_len[b] = (int32_t)len;
        } else {
          return kStatusDataError;  // encoder emits <= 2 chunks per block
        }
        ++chunk;
        br.SeekByte(p + len);
        if ((int64_t)(8 * (p + len)) >= end) break;
        br.Read(1);
        if (br.Read(2) != 0 || br.Overrun()) return kStatusDataError;
        br.AlignByte();
      }
      continue;
    }
    HuffDecodeTable dyn_lit, dyn_dist;
    const HuffDecodeTable* lit;
    const HuffDecodeTable* dist;
    if (btype == 1) {
      lit = &GetFixedTables().lit;
      dist = &GetFixedTables().dist;
    } else {
      uint32_t hlit = br.Read(5) + 257;
      uint32_t hdist = br.Read(5) + 1;
      uint32_t hclen = br.Read(4) + 4;
      uint8_t cl_len[19] = {0};
      for (uint32_t i = 0; i < hclen; ++i)
        cl_len[kClOrder[i]] = (uint8_t)br.Read(3);
      if (br.Overrun()) return kStatusUnexpectedEof;
      HuffDecodeTable cl;
      if (!BuildDecodeTable(cl_len, 19, true, &cl) || cl.bits == 0)
        return kStatusDataError;
      uint8_t lens[288 + 32] = {0};
      uint32_t total = hlit + hdist;
      uint32_t i = 0;
      while (i < total) {
        int sym = DecodeSym(&br, cl);
        if (br.Overrun() || sym < 0) return kStatusDataError;
        if (sym < 16) {
          lens[i++] = (uint8_t)sym;
        } else if (sym == 16) {
          if (i == 0) return kStatusDataError;
          uint32_t rep = 3 + br.Read(2);
          if (i + rep > total) return kStatusDataError;
          uint8_t v = lens[i - 1];
          while (rep--) lens[i++] = v;
        } else if (sym == 17) {
          uint32_t rep = 3 + br.Read(3);
          if (i + rep > total) return kStatusDataError;
          i += rep;
        } else {
          uint32_t rep = 11 + br.Read(7);
          if (i + rep > total) return kStatusDataError;
          i += rep;
        }
      }
      if (br.Overrun()) return kStatusUnexpectedEof;
      if (!BuildDecodeTable(lens, (int)hlit, true, &dyn_lit))
        return kStatusDataError;
      uint8_t dlens[32] = {0};
      std::memcpy(dlens, lens + hlit, hdist);
      if (!BuildDecodeTable(dlens, (int)hdist, true, &dyn_dist))
        return kStatusDataError;
      if (dyn_lit.bits == 0) return kStatusDataError;
      lit = &dyn_lit;
      dist = &dyn_dist;
    }
    // Bit position after the header = 8*pos - buffered bits; mid-block
    // segments (InflateIndex) override with their first symbol bit.
    br.Fill();
    body_bit[b] = (seg_bits && seg_bits[b] >= 0) ? seg_bits[b]
                                                 : (int64_t)br.BitPos();
    lit_bits[b] = lit->bits;
    dist_bits[b] = dist->bits;
    // Two-level emit; a (valid) pathological tree overflowing l2 marks
    // the block with lit_bits = -1 — a device-decline, not an error.
    uint32_t* lt = lit_tab + (size_t)b * kLitTW;
    uint32_t* dt = dist_tab + (size_t)b * kDistTW;
    bool ok = EmitTwoLevelLSB(*lit, lt, lt + kL1, kInflateLitL2);
    if (!dist->entries.empty())
      ok = ok && EmitTwoLevelLSB(*dist, dt, dt + kL1, kInflateDistL2);
    if (!ok) lit_bits[b] = -1;
  }
  return kStatusOk;
}

// ---------------------------------------------------------------------------
// Token-aligned segment index (SURVEY.md §7.4 route 2): one symbol walk
// without output materialization cuts any foreign/own raw DEFLATE stream
// into device-decodable segments. See deflate.h for the record layout.
// ---------------------------------------------------------------------------

namespace {

// Parses a dynamic block's code-length section into decode tables.
// Returns 0 ok / status code on malformed input.
int ParseDynTables(BitReaderLSB* br, HuffDecodeTable* dyn_lit,
                   HuffDecodeTable* dyn_dist) {
  uint32_t hlit = br->Read(5) + 257;
  uint32_t hdist = br->Read(5) + 1;
  uint32_t hclen = br->Read(4) + 4;
  uint8_t cl_len[19] = {0};
  for (uint32_t i = 0; i < hclen; ++i)
    cl_len[kClOrder[i]] = (uint8_t)br->Read(3);
  if (br->Overrun()) return kStatusUnexpectedEof;
  HuffDecodeTable cl;
  if (!BuildDecodeTable(cl_len, 19, true, &cl) || cl.bits == 0)
    return kStatusDataError;
  uint8_t lens[288 + 32] = {0};
  uint32_t total = hlit + hdist;
  uint32_t i = 0;
  while (i < total) {
    int sym = DecodeSym(br, cl);
    if (br->Overrun() || sym < 0) return kStatusDataError;
    if (sym < 16) {
      lens[i++] = (uint8_t)sym;
    } else if (sym == 16) {
      if (i == 0) return kStatusDataError;
      uint32_t rep = 3 + br->Read(2);
      if (i + rep > total) return kStatusDataError;
      uint8_t v = lens[i - 1];
      while (rep--) lens[i++] = v;
    } else if (sym == 17) {
      uint32_t rep = 3 + br->Read(3);
      if (i + rep > total) return kStatusDataError;
      i += rep;
    } else {
      uint32_t rep = 11 + br->Read(7);
      if (i + rep > total) return kStatusDataError;
      i += rep;
    }
  }
  if (br->Overrun()) return kStatusUnexpectedEof;
  if (!BuildDecodeTable(lens, (int)hlit, true, dyn_lit))
    return kStatusDataError;
  uint8_t dlens[32] = {0};
  std::memcpy(dlens, lens + hlit, hdist);
  if (!BuildDecodeTable(dlens, (int)hdist, true, dyn_dist))
    return kStatusDataError;
  if (dyn_lit->bits == 0) return kStatusDataError;
  return kStatusOk;
}

}  // namespace

int InflateIndex(const uint8_t* in, size_t n, int64_t seg_out,
                 int64_t max_segs, int64_t max_span_bytes,
                 int64_t* hdr_bits, int64_t* seg_bits, int64_t* end_bits,
                 int64_t* out_lens, int32_t* carry_len, int32_t* carry_dist,
                 int64_t* nseg_out, size_t* consumed_bytes) {
  BitReaderLSB br(in, n);
  int64_t nseg = 0;
  int64_t out_pos = 0;
  int64_t seg_start_out = 0;
  int64_t cur_hdr = 0;
  int64_t cur_seg_bit = -1;
  int32_t pend_carry_len = 0, pend_carry_dist = 0;
  bool bfinal = false;

  auto close_seg = [&](int64_t end_bit, int64_t seg_len, int32_t ncl,
                       int32_t ncd) -> int {
    if (nseg >= max_segs) return kStatusDataError;
    if ((end_bit + 7) / 8 - cur_seg_bit / 8 > max_span_bytes)
      return kStatusDataError;
    hdr_bits[nseg] = cur_hdr;
    seg_bits[nseg] = cur_seg_bit;
    end_bits[nseg] = end_bit;
    out_lens[nseg] = seg_len;
    carry_len[nseg] = pend_carry_len;
    carry_dist[nseg] = pend_carry_dist;
    ++nseg;
    seg_start_out += seg_len;
    pend_carry_len = ncl;
    pend_carry_dist = ncd;
    return kStatusOk;
  };

  while (!bfinal) {
    int64_t hdr_bit = (int64_t)br.BitPos();
    // Block boundary: tables change, so any open segment must cut here.
    if (cur_seg_bit >= 0 && out_pos > seg_start_out) {
      int st = close_seg(hdr_bit, out_pos - seg_start_out, 0, 0);
      if (st != kStatusOk) return st;
    }
    bfinal = br.Read(1) != 0;
    uint32_t btype = br.Read(2);
    if (br.Overrun()) return kStatusUnexpectedEof;
    if (btype == 3) return kStatusDataError;
    if (btype == 0) {
      // A stored block is one LEN<=65535 chunk — it becomes its own
      // segment (out_len <= 64 KiB fits the device layout; the scan's
      // stored path and the resolve's slice gather handle it natively).
      br.AlignByte();
      uint32_t len = br.Read(16);
      uint32_t nlen = br.Read(16);
      if (br.Overrun()) return kStatusUnexpectedEof;
      if ((len ^ nlen) != 0xffff) return kStatusDataError;
      size_t p = br.BytePos();
      if (p + len > n) return kStatusUnexpectedEof;
      br.SeekByte(p + len);
      if (len == 0) continue;  // Z_SYNC_FLUSH-style marker, no output
      cur_hdr = hdr_bit;
      cur_seg_bit = hdr_bit;  // unused by the walk (btype 0), spans slice
      out_pos += (int64_t)len;
      int st = close_seg((int64_t)(8 * (p + len)), out_pos - seg_start_out,
                         0, 0);
      if (st != kStatusOk) return st;
      cur_seg_bit = -1;
      continue;
    }
    HuffDecodeTable dyn_lit, dyn_dist;
    const HuffDecodeTable* lit;
    const HuffDecodeTable* dist;
    if (btype == 1) {
      lit = &GetFixedTables().lit;
      dist = &GetFixedTables().dist;
    } else {
      int st = ParseDynTables(&br, &dyn_lit, &dyn_dist);
      if (st != kStatusOk) return st;
      lit = &dyn_lit;
      dist = &dyn_dist;
    }
    cur_hdr = hdr_bit;
    br.Fill();
    cur_seg_bit = (int64_t)br.BitPos();
    for (;;) {
      int sym = DecodeSym(&br, *lit);
      if (br.Overrun()) return kStatusUnexpectedEof;
      if (sym < 0) return kStatusDataError;
      if (sym == 256) break;
      uint32_t adv, d = 0;
      if (sym < 256) {
        adv = 1;
      } else {
        if (sym > 285) return kStatusDataError;
        adv = kLengthBase[sym - 257] + br.Read(kLengthExtra[sym - 257]);
        if (dist->bits == 0) return kStatusDataError;
        int ds = DecodeSym(&br, *dist);
        if (br.Overrun()) return kStatusUnexpectedEof;
        if (ds < 0 || ds > 29) return kStatusDataError;
        d = kDistBase[ds] + br.Read(kDistExtra[ds]);
        if (br.Overrun()) return kStatusUnexpectedEof;
        if ((int64_t)d > out_pos) return kStatusDataError;
      }
      out_pos += adv;
      int64_t over = out_pos - (seg_start_out + seg_out);
      if (over >= 0) {
        // A length token can cross at most one boundary (258 < seg_out).
        if (over > 0 && d == 0) return kStatusDataError;  // impossible
        int64_t after = (int64_t)br.BitPos();
        int st = close_seg(after, seg_out, (int32_t)over, (int32_t)d);
        if (st != kStatusOk) return st;
        cur_seg_bit = after;
      }
    }
    // EOB consumed; the segment stays open — it closes at the next block
    // header (tables cut) or at stream end below, so end_bits include
    // the EOB bits for slice sizing.
  }
  if (cur_seg_bit >= 0 && out_pos > seg_start_out) {
    int st = close_seg((int64_t)br.BitPos(), out_pos - seg_start_out, 0, 0);
    if (st != kStatusOk) return st;
  }
  br.AlignByte();
  if (br.Overrun()) return kStatusUnexpectedEof;
  if (consumed_bytes) *consumed_bytes = br.BytePos();
  *nseg_out = nseg;
  return kStatusOk;
}

}  // namespace tpz
