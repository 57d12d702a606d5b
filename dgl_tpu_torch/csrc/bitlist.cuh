// A warp's listing of the set bits of one row of a bit packing, and the
// check of a listed walk's lanes, shared by the listed-bit walks: K5's two
// walks (bitgat.cu) and K7's three walks (bitdot.cu).
//
// Packing (plane-major, dgl_tpu/ops/pallas/bitmm.py:19-27): with k32 words
// a row, bit b of word j <-> column b * k32 + j.  Bit 31 is the int32 sign
// bit, so words are read as uint32_t.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStepWords = 8;      // words a lane loads a step
constexpr int kList = 256;         // entries a warp's list holds
constexpr int kListDrainAt = 128;  // a list this long is drained

// The row's words, kStepWords a lane a step (lane L, word u: j = j0 + 32 u
// + L), the next step's requested before this one is listed: list_start
// requests the first step.  A warp prefix sum of popcounts gives each lane
// its place in the warp's list, where it writes its bits word by word,
// lowest first, as the column b * k32 + j (-1 at or past num_cols).
// list_bits lists entries at list[len ..] until the list is full (the rest
// of the step in hand waits for the next call), holds kListDrainAt entries
// at the end of a step, or the row ends (then row_done is set); the caller
// drains the list, sets len to 0 and calls it again until row_done.  The
// state is the caller's own locals, passed by reference, and everything
// but `first` is warp-uniform: held in a struct, the same listing compiled
// to a slower backward at the walks' 128 registers on the H100.
__device__ __forceinline__ void list_start(uint32_t (&word)[kStepWords],
                                           uint32_t (&next)[kStepWords],
                                           const uint32_t* prow, int64_t k32,
                                           int lane) {
#pragma unroll
  for (int u = 0; u < kStepWords; ++u) {
    const int64_t j = u * 32 + lane;
    next[u] = j < k32 ? __ldg(prow + j) : 0u;
    word[u] = 0u;
  }
}

__device__ __forceinline__ void list_bits(
    int* list, int& len, bool& row_done, uint32_t (&word)[kStepWords],
    uint32_t (&next)[kStepWords], int64_t& j0, int& total, int& first,
    int& p0, const uint32_t* prow, int64_t k32, int64_t num_cols, int lane) {
  for (;;) {
    if (p0 == total) {  // the step in hand is listed
      if (len >= kListDrainAt) break;
      j0 += 32 * kStepWords;
      if (j0 >= k32) {
        row_done = true;
        break;
      }
      int c = 0;
#pragma unroll
      for (int u = 0; u < kStepWords; ++u) {
        word[u] = next[u];
        c += __popc(word[u]);
        const int64_t j = j0 + 32 * kStepWords + u * 32 + lane;
        next[u] = j < k32 ? __ldg(prow + j) : 0u;
      }
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      total = __shfl_sync(kFull, incl, 31);
      first = incl - c;
      p0 = 0;
      continue;
    }
    if (len == kList) break;
    // entries p0 .. p0 + take - 1 of the step, at list[len ..]
    const int take = min(kList - len, total - p0);
    int idx = first;
#pragma unroll
    for (int u = 0; u < kStepWords; ++u) {
      uint32_t bits = word[u];
      const int pc = __popc(bits);
      if (idx + pc <= p0 || idx >= p0 + take) {  // none listed now
        idx += pc;
        continue;
      }
      const int64_t j = j0 + u * 32 + lane;
      while (bits) {
        const int b = __ffs(static_cast<int>(bits)) - 1;
        bits &= bits - 1u;
        if (idx >= p0 && idx < p0 + take) {
          const int64_t col = static_cast<int64_t>(b) * k32 + j;
          list[len + idx - p0] =
              col < num_cols ? static_cast<int>(col) : -1;
        }
        ++idx;
      }
    }
    len += take;
    p0 += take;
  }
}

// A listed walk's layout checks (lpe lanes an entry, a power of two up
// to 32; cpl = ceil(nv / lpe) <= 4 vectors a lane; with H > 1, vph = dp /
// 4 a power of two dividing lpe).
bool list_layout_ok(int64_t heads, int64_t dp, int64_t lpe, int64_t cpl) {
  const int64_t vph = dp / 4, nv = heads * vph;
  return heads >= 1 && dp >= 4 && dp % 4 == 0 && lpe >= 1 && lpe <= 32 &&
         (lpe & (lpe - 1)) == 0 && cpl >= 1 && cpl <= 4 &&
         (nv + lpe - 1) / lpe == cpl &&
         !(heads > 1 && ((vph & (vph - 1)) != 0 || lpe % vph != 0));
}

}  // namespace
