// A walk over the (row, unit) pairs of a row-major tile by a fixed stride,
// shared by the kernels whose threads move a tile's words or pieces in
// flat order (B4's output tile, B5's padded row stage).

#pragma once

namespace muscato {

// Output unit u0, u0 + stride, ... of a tile whose rows hold `per` units
// each, as (row j, unit c), advanced without dividing.
struct RowWalk {
  int j, c, dj, dc, per;
  __device__ RowWalk(int u0, int stride, int per_)
      : j(u0 / per_), c(u0 % per_), dj(stride / per_), dc(stride % per_), per(per_) {}
  __device__ void next() {
    j += dj;
    c += dc;
    if (c >= per) {
      c -= per;
      ++j;
    }
  }
};

}  // namespace muscato
