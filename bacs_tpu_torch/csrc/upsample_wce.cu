// The C entry points of K4 (class-weighted CE, the dark++ replay term:
// forward sums and gradient), on the templates of upsample_ce.cuh (the
// family's design, bound and tolerance).

#include "upsample_ce.cuh"

// K4 forward, weights f32 [c]: a_out = per-image sums of w[t] NLL, b_out =
// per-image sums of w[t].
extern "C" int upsample_wce_sums(const void* sem, int sem_is_bf16, const void* labels,
                                 int labels_are_i64, int n, int h, int w, int c, int H,
                                 int W, int ignore_index, const void* weights,
                                 const void* tables, int band, int tile, int span,
                                 int rows, void* partials, void* loss_out,
                                 void* wsum_out, void* stream) {
  return sums(PROBLEM, WceTerm{(const float*)weights}, partials, loss_out, wsum_out,
              stream);
}

// K4 backward.
extern "C" int upsample_wce_grad(const void* sem, int sem_is_bf16, const void* labels,
                                 int labels_are_i64, int n, int h, int w, int c, int H,
                                 int W, int ignore_index, const void* weights,
                                 const void* g, const void* tables, int band, int tile,
                                 int span, int rows, void* partials, void* dsem,
                                 void* stream) {
  return grad(PROBLEM, WceTerm{(const float*)weights}, g, partials, dsem, stream);
}
