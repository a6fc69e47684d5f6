// The C entry points of K3 (BACS seen-weighted CE: forward sums and
// gradient), on the templates of upsample_ce.cuh (the family's design,
// bound and tolerance).

#include "upsample_ce.cuh"

// K3 forward, max_seen f32 [n, H, W]: a_out = per-image sums of the BACS
// terms, b_out = valid counts.
extern "C" int upsample_bacs_sum(const void* sem, int sem_is_bf16, const void* labels,
                                 int labels_are_i64, int n, int h, int w, int c, int H,
                                 int W, int ignore_index, const void* max_seen,
                                 int old_classes, int ukd, float gamma, float threshold,
                                 const void* tables, int band, int tile, int span,
                                 int rows, void* partials, void* loss_out,
                                 void* count_out, void* stream) {
  const BacsTerm term{(const float*)max_seen, old_classes, ukd, gamma, threshold};
  return sums(PROBLEM, term, partials, loss_out, count_out, stream);
}

// K3 backward.
extern "C" int upsample_bacs_grad(const void* sem, int sem_is_bf16, const void* labels,
                                  int labels_are_i64, int n, int h, int w, int c, int H,
                                  int W, int ignore_index, const void* max_seen,
                                  int old_classes, int ukd, float gamma,
                                  float threshold, const void* g, const void* tables,
                                  int band, int tile, int span, int rows,
                                  void* partials, void* dsem, void* stream) {
  const BacsTerm term{(const float*)max_seen, old_classes, ukd, gamma, threshold};
  return grad(PROBLEM, term, g, partials, dsem, stream);
}
