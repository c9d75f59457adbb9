// K3's temporal band (gen3c_tpu/models/dit.py:370-409) for the bf16
// attention kernels of attention_bwd.cu and attention_wgmma.cu: the Band
// kernel argument and the tile-range and visibility helpers both use.
//
// Query token i sees key token j iff |i/hw - j/hw| <= window or
// j/hw < prefix. A source includes this file inside its anonymous namespace,
// so Band keeps the source's own namespace and the kernels' symbols are what
// they were when each source held its own copy; it includes nothing itself.

#pragma once

// The band, a kernel argument of its own: fields added to a kernel's
// parameter struct cost it registers (attention.cu's K3 note: one more
// field took K1 from 127 to 130 registers and 2.3x its time). q_off and k_off are the global sequence
// positions of the call's first query and key: nonzero only in a
// ring-attention step (K1ring), whose queries and keys are shards of a
// longer sequence.
struct Band {
  int hw, window, prefix;        // hw <= 0: full attention
  unsigned long long* visited;   // optional tile counters (see the entry points)
  int q_off, k_off;
};

// Key-tile ranges [b0, e0) and [b1, e1) (the second may be empty) of the
// call's keys (global positions k_off + j, j < Lk) that hold a key visible
// to a query of global positions [q_first, q_last]: the prefix frames and
// the frames within the window of the queries' frames, merged where they
// touch (attention.cu's kv_tile_ranges; k_off = 0 is that function).
__device__ __forceinline__ void band_key_tiles(const Band& band, int Lk, int q_first,
                                               int q_last, int tile, int& b0, int& e0,
                                               int& b1, int& e1, int k_off = 0) {
  b0 = 0;
  e0 = (Lk + tile - 1) / tile;
  b1 = e1 = 0;
  if (band.hw <= 0) return;
  const long long hw = band.hw;
  const long long pre_end = min(static_cast<long long>(band.prefix) * hw - k_off,
                                static_cast<long long>(Lk));
  e0 = pre_end > 0 ? static_cast<int>((pre_end + tile - 1) / tile) : 0;
  const long long lo = max(0LL, max(0LL, q_first / hw - band.window) * hw - k_off);
  const long long hi =
      min((q_last / hw + band.window + 1) * hw - k_off, static_cast<long long>(Lk));
  if (lo < hi) {
    b1 = static_cast<int>(lo / tile);
    e1 = static_cast<int>((hi + tile - 1) / tile);
  }
  if (b1 < e1 && b1 <= e0) {  // the ranges touch: one range
    e0 = max(e0, e1);
    b1 = e1 = 0;
  }
}

// Query-tile range [b, e) whose queries see a key of [k_first, k_last]: all
// of them if one key is a prefix key, else the frames within the window.
__device__ __forceinline__ void band_query_tiles(const Band& band, int Lq, int k_first,
                                                 int k_last, int tile, int& b, int& e) {
  b = 0;
  e = (Lq + tile - 1) / tile;
  if (band.hw <= 0) return;
  const long long hw = band.hw;
  const long long kf_lo = k_first / hw;
  if (kf_lo < band.prefix) return;
  const long long lo = max(0LL, kf_lo - band.window) * hw;
  const long long hi = min((k_last / hw + band.window + 1) * hw, static_cast<long long>(Lq));
  if (lo >= hi) {
    b = e = 0;
    return;
  }
  b = static_cast<int>(lo / tile);
  e = static_cast<int>((hi + tile - 1) / tile);
}

// True when every key of [n0, n0 + ntile) exists and every query of frames
// qf_lo..qf_hi sees it, so that the tile needs no mask (attention.cu's
// tile_all_visible). The keys sit at global positions k_off + n0 onward.
__device__ __forceinline__ bool band_tile_visible(const Band& band, int Lk, int n0, int ntile,
                                                  int qf_lo, int qf_hi, int k_off = 0) {
  const long long end = static_cast<long long>(n0) + ntile;
  if (end > Lk) return false;
  if (band.hw <= 0) return true;
  const long long hw = band.hw;
  const long long g0 = static_cast<long long>(n0) + k_off, g_end = end + k_off;
  if (g_end <= static_cast<long long>(band.prefix) * hw) return true;
  return g0 >= (qf_hi - band.window) * hw &&
         g_end <= (static_cast<long long>(qf_lo) + band.window + 1) * hw;
}

// Whether a query of frame qf sees a key of frame kf under the band.
__device__ __forceinline__ bool band_frames_visible(const Band& band, int qf, int kf) {
  return kf < band.prefix || abs(qf - kf) <= band.window;
}

// The same for tokens q and k (hw <= 0: full attention).
__device__ __forceinline__ bool band_tokens_visible(const Band& band, int q, int k) {
  return band.hw <= 0 || band_frames_visible(band, q / band.hw, k / band.hw);
}
