// The C entry points of K6 (MiB's unbiased CE: forward sums and
// gradient), on the templates of upsample_ce.cuh (the family's design,
// bound and tolerance).

#include "upsample_ce.cuh"

// K6 forward: a_out = per-image sums of the unbiased CE, b_out = valid
// counts.
extern "C" int upsample_uce_sums(const void* sem, int sem_is_bf16, const void* labels,
                                 int labels_are_i64, int n, int h, int w, int c, int H,
                                 int W, int ignore_index, int old_classes,
                                 const void* tables, int band, int tile, int span,
                                 int rows, void* partials, void* loss_out,
                                 void* count_out, void* stream) {
  return sums(PROBLEM, UceTerm{old_classes}, partials, loss_out, count_out, stream);
}

// K6 backward.
extern "C" int upsample_uce_grad(const void* sem, int sem_is_bf16, const void* labels,
                                 int labels_are_i64, int n, int h, int w, int c, int H,
                                 int W, int ignore_index, int old_classes,
                                 const void* g, const void* tables, int band, int tile,
                                 int span, int rows, void* partials, void* dsem,
                                 void* stream) {
  return grad(PROBLEM, UceTerm{old_classes}, g, partials, dsem, stream);
}
