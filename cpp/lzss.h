// LZSS match finding + parse — the shared "parse spec v1".
//
// Parity: reference crate src/lzss/ (generic LzssEncoder/LzssDecoder
// emitting LzssCode::{Symbol, Reference{len,pos}}, [HIGH] SURVEY.md §2.1).
// The crate's search structure is unknown (SURVEY.md §0.1 Q1); this module
// instead defines OUR deterministic spec, implemented identically here and
// in the device kernels (tpz/kernels/matchfinder.py + parse.py) so oracle and
// device produce byte-identical token streams:
//
//   - hash: h(i) = low 3 bytes * 0x9E3779B1 >> (32 - hash_bits)
//   - candidates at i: the first `max_chain` positions j < i with h(j) ==
//     h(i), most recent first, with i - j <= window (all positions are
//     inserted, including inside matches)
//   - screening: each candidate scored by its LCP clamped to min(8, cap)
//     where cap = min(max_match, block_end - i); the winner is the best
//     screen, ties to the more recent candidate
//   - extension (spec v2): when the winner's screen is saturated
//     (== min(8, cap)), the first n_extend saturated candidates (in
//     recency order) are extended to their full LCP and the longest wins,
//     ties to the more recent (zlib's strictly-longer-replaces rule)
//   - too-far rule: a match of length == min_match with distance > 4096 is
//     demoted to a literal
//   - parse: greedy per block (lazy=0) or one-step lazy (lazy=1): if the
//     match starting at i+1 is strictly longer than the one at i, emit a
//     literal at i; the lazy probe is skipped when len >= max_lazy
//     (zlib's max_lazy heuristic)
//   - blocks: the parse restarts at every block boundary (block_size input
//     bytes); matches never cross a block end but distances may reach back
//     across blocks (up to window) — this is what makes per-block device
//     kernels bit-identical to this oracle (SURVEY.md §7 hard part 1)
#pragma once

#include <cstdint>
#include <cstddef>
#include <vector>

namespace tpz {

struct LzssParams {
  int window = 32768;
  int min_match = 3;
  int max_match = 258;
  int max_chain = 16;   // candidate count K
  int hash_bits = 15;
  int block_size = 65536;
  bool lazy = false;
  bool too_far_rule = true;
  int too_far = 4096;
  int max_lazy = 258;     // lazy probe only when current match < max_lazy
  int n_extend = 1;       // saturated candidates fully extended (<= 8)
  int screen_bytes = 8;   // screening LCP clamp (8 or 16)
  // Candidate source: 0 = hash3 chains (K = max_chain most recent).
  // 1 = suffix-space neighbors ("spec v3"): sort every in-halo position by
  //     its 16-byte prefix (big-endian word order) breaking ties by
  //     position; candidates at i are its max_chain nearest sorted
  //     neighbors in EACH direction that are insertable, in-window
  //     predecessors. Winner/runner-up are the top-2 by (screen, recency);
  //     both are fully extended when their screens saturate.
  int suffix_mode = 0;
  // Parse restart interval (suffix_mode only; 0 = off): match lengths are
  // additionally capped so no token crosses a `restart`-aligned boundary
  // within the parse block. Restarting the greedy chain every `restart`
  // bytes makes the block's parse a set of independent sub-walks, which
  // a parallel walk can advance side by side. Must be a power of two
  // dividing block_size.
  int restart = 0;
};

// One token: literal (len == 0, lit = byte) or match (len >= min, dist >= 1).
struct Token {
  uint32_t pos;   // input position the token starts at
  uint16_t len;   // 0 for literal
  uint16_t lit;   // literal byte when len == 0
  uint32_t dist;  // match distance when len > 0
};

// Tokenize in[0..n) per the spec above. Appends to `out`.
void LzssTokenize(const uint8_t* in, size_t n, const LzssParams& p,
                  std::vector<Token>* out);

}  // namespace tpz
