// CPU build of the draw body (draws.cuh) behind the plain C interface of
// draws.cu, for the tests: every (row, node) worker in turn, on host
// pointers laid out as the kernel takes them, plus the threefry functions
// alone (`rs_draws_threefry`) for their unit test.
//
//   g++ -std=c++17 -O2 -Wall -Werror -fPIC -shared -o libdraws_host.so draws_host.cpp
#include <cstdint>

#include "draws.cuh"

extern "C" int rs_draws_host(const rd::DrawParams* p, void* const* ptrs) {
  const int bad = rd::check_params(*p);
  if (bad) return 100 + bad;
  rd::DrawArgs args;
  args.p = *p;
  for (int k = 0; k < rd::N_PTR; ++k) args.ptr[k] = ptrs[k];
  for (int i = 0; i < p->n; ++i)
    for (int64_t r = 0; r < p->rows; ++r) rd::draw_node(args, r, i);
  return 0;
}

extern "C" int rs_draws_n_ptr() { return rd::N_PTR; }

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
