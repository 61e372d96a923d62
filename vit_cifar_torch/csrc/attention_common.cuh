// What the attention entry points (mhsa_fwd.cu, flash_*.cu) share: the
// (b, h, t) strides of the views they are given.

#pragma once

#include <cstdint>

namespace attn {

// The (b, h, t) strides in elements of n (B, H, T, D) views as the caller
// has them, d's being 1.
template <int n>
struct Views {
  int64_t sb[n], sh[n], st[n];

  // from the entry points' array: each view's (sb, sh, st) in turn
  static Views from(const long long* s) {
    Views l;
    for (int x = 0; x < n; ++x) {
      l.sb[x] = s[3 * x];
      l.sh[x] = s[3 * x + 1];
      l.st[x] = s[3 * x + 2];
    }
    return l;
  }
};

// The forwards': index 0 is q, 1 k, 2 v.
using Qkv = Views<3>;
// The backward pair's: 0 q, 1 k, 2 v, 3 o, 4 do (o and do as views of their
// (B, T, H, D) tensors), 5 dq or dk, 6 dv.
using BwdLayout = Views<7>;

}  // namespace attn
