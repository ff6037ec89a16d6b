// CPU build of the draw body (draws.cuh) behind the plain C interface of
// draws.cu, for the tests: per tile of rd::tile_rows rows (as the card's
// blocks), every (row, node) worker's stage phase, then every worker's draw
// phase -- the barrier's meaning -- on host pointers laid out as the kernel
// takes them, plus the threefry functions alone (`rs_draws_threefry`) for
// their unit test. `reverse` runs each phase's workers in reverse order, so
// a draw that reads a byte its own phase has not staged yet differs from
// the forward run; `poison` fills the staging with the race proxy's byte
// before each tile's stage phase, so a read of a byte no worker staged
// differs too.
//
//   g++ -std=c++17 -O2 -Wall -Werror -fPIC -shared -o libdraws_host.so draws_host.cpp
#include <cstdint>
#include <cstring>
#include <vector>

#include "draws.cuh"

extern "C" int rs_draws_host(const rd::DrawParams* p, void* const* ptrs, int reverse,
                             int poison) {
  const int bad = rd::check_params(*p);
  if (bad) return 100 + bad;
  rd::DrawArgs args;
  args.p = *p;
  for (int k = 0; k < rd::N_PTR; ++k) args.ptr[k] = ptrs[k];
  const int n = p->n, rt = rd::tile_rows(n);
  std::vector<uint8_t> mem((std::size_t)rd::stage_bytes(n, rt), 0);
  const rd::Stage st{mem.data(), rt, rd::stage_stride(n)};
  std::vector<rd::RowCtx> ctx((std::size_t)rt * n);
  for (int64_t r0 = 0; r0 < p->rows; r0 += rt) {
    const int live = (int)(p->rows - r0 < rt ? p->rows - r0 : rt);
    if (poison) std::memset(mem.data(), rd::POISON, mem.size());
    for (int phase = 0; phase < 2; ++phase) {
      for (int k = 0; k < live * n; ++k) {
        const int w = reverse ? live * n - 1 - k : k;
        const int local = w % live, i = w / live;
        rd::RowCtx& x = ctx[(std::size_t)local * n + i];
        if (phase == 0) rd::stage_node(args, st, r0 + local, local, i, x);
        else rd::draw_node(args, st, r0 + local, local, i, x);
      }
    }
  }
  return 0;
}

extern "C" int rs_draws_n_ptr() { return rd::N_PTR; }
extern "C" int rs_draws_tile_rows(int n) { return rd::tile_rows(n); }

// The threefry functions on `count` keys and words: `op` 0 the block
// (out[2j], out[2j+1]), 1 fold_in(key, x0), 2 bits(key, pos x0:x1), 3
// randint(key, pos x0, lo, hi). Keys are uint32 pairs.
extern "C" void rs_draws_threefry(int op, int64_t count, const uint32_t* keys,
                                  const uint32_t* x0, const uint32_t* x1, int64_t lo, int64_t hi,
                                  uint32_t* out) {
  for (int64_t j = 0; j < count; ++j) {
    const rd::Key k{keys[2 * j], keys[2 * j + 1]};
    if (op == 0 || op == 1) {
      const rd::Key o = op == 0 ? rd::threefry2x32(k, x0[j], x1[j]) : rd::fold_in(k, x0[j]);
      out[2 * j] = o.a;
      out[2 * j + 1] = o.b;
    } else if (op == 2) {
      out[j] = rd::bits(k, ((uint64_t)x0[j] << 32) | x1[j]);
    } else {
      out[j] = (uint32_t)rd::randint(k, x0[j], lo, hi);
    }
  }
}
