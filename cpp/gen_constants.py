#!/usr/bin/env python
"""Generate cpp/generated_constants.h from tpz/constants.py.

Single-source-of-truth discipline (SURVEY.md §7 hard part 6): the C++ oracle
and the JAX kernels consume the same spec tables, so they cannot drift.
Run automatically by cpp/Makefile; the generated header is not committed.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tpz import constants as C  # noqa: E402


def fmt_array(name, arr, ctype):
    vals = ", ".join(str(int(v)) for v in arr)
    return f"static const {ctype} {name}[{len(arr)}] = {{{vals}}};\n"


def render() -> str:
    parts = [
        "// AUTO-GENERATED by cpp/gen_constants.py from tpz/constants.py.\n"
        "// Do not edit by hand.\n"
        "#pragma once\n#include <cstdint>\n\nnamespace tpz {\n\n",
        fmt_array("kLengthBase", C.DEFLATE_LENGTH_BASE, "int32_t"),
        fmt_array("kLengthExtra", C.DEFLATE_LENGTH_EXTRA, "int32_t"),
        fmt_array("kDistBase", C.DEFLATE_DIST_BASE, "int32_t"),
        fmt_array("kDistExtra", C.DEFLATE_DIST_EXTRA, "int32_t"),
        fmt_array("kClOrder", C.DEFLATE_CL_ORDER, "int32_t"),
        fmt_array("kFixedLitLenLengths", C.DEFLATE_FIXED_LITLEN_LENGTHS, "uint8_t"),
        fmt_array("kFixedDistLengths", C.DEFLATE_FIXED_DIST_LENGTHS, "uint8_t"),
        fmt_array("kLengthSymTable", C.DEFLATE_LENGTH_SYM_TABLE, "int16_t"),
        fmt_array("kDistSymLo", C.DEFLATE_DIST_SYM_LO, "int16_t"),
        fmt_array("kDistSymHi", C.DEFLATE_DIST_SYM_HI, "int16_t"),
        fmt_array("kCrcTableReflected", C.CRC32_TABLE_REFLECTED, "uint32_t"),
        fmt_array("kCrcTableMsb", C.CRC32_TABLE_MSB, "uint32_t"),
        f"static const uint32_t kAdlerMod = {C.ADLER32_MOD};\n",
        f"static const int kDeflateMinMatch = {C.DEFLATE_MIN_MATCH};\n",
        f"static const int kDeflateMaxMatch = {C.DEFLATE_MAX_MATCH};\n",
        f"static const int kDeflateWindow = {C.DEFLATE_WINDOW};\n",
        f"static const int kDeflateMaxBits = {C.DEFLATE_MAX_BITS};\n",
        f"static const int kDeflateMaxClBits = {C.DEFLATE_MAX_CL_BITS};\n",
        f"static const int kNumLitLen = {C.DEFLATE_NUM_LITLEN};\n",
        f"static const int kNumDist = {C.DEFLATE_NUM_DIST};\n",
        f"static const int kNumCl = {C.DEFLATE_NUM_CL};\n",
        f"static const int kInflateL1Bits = {C.INFLATE_L1_BITS};\n",
        f"static const int kInflateLitL2 = {C.INFLATE_LIT_L2};\n",
        f"static const int kInflateDistL2 = {C.INFLATE_DIST_L2};\n",
        f"static const uint64_t kBzBlockMagic = 0x{C.BZIP2_BLOCK_MAGIC:012x}ULL;\n",
        f"static const uint64_t kBzEosMagic = 0x{C.BZIP2_EOS_MAGIC:012x}ULL;\n",
        f"static const int kBzBlockUnit = {C.BZIP2_BLOCK_UNIT};\n",
        f"static const int kBzMaxAlpha = {C.BZIP2_MAX_ALPHA};\n",
        f"static const int kBzMaxCodeLen = {C.BZIP2_MAX_CODE_LEN};\n",
        f"static const int kBzGroupSize = {C.BZIP2_GROUP_SIZE};\n",
        f"static const int kBzNIters = {C.BZIP2_N_ITERS};\n",
        f"static const int kLzhufMinMatch = {C.LZHUF_MIN_MATCH};\n",
        f"static const int kLzhufMaxMatch = {C.LZHUF_MAX_MATCH};\n",
        f"static const int kLzhufNc = {C.LZHUF_NC};\n",
        f"static const int kLzhufNt = {C.LZHUF_NT};\n",
        f"static const int kLzhufCbit = {C.LZHUF_CBIT};\n",
        f"static const int kLzhufTbit = {C.LZHUF_TBIT};\n",
        f"static const int kLzhufMaxCodeLen = {C.LZHUF_MAX_CODE_LEN};\n",
        "\n}  // namespace tpz\n",
    ]
    return "".join(parts)


def main(out_path):
    with open(out_path, "w") as f:
        f.write(render())
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else
         os.path.join(os.path.dirname(__file__), "generated_constants.h"))
